// The attention forward kernels (attention.cu) at head dim 32: the towers of
// the learned-retrieval example (examples_torch/, hidden 128 in 4 heads).
// Built in a source of their own so that nvcc compiles them beside
// attention.cu's; attention.cu dispatches here.
#include "attention_fwd.cuh"

namespace attn_fwd {
ISX_ATTN_FWD_HD(, 32)
}  // namespace attn_fwd
