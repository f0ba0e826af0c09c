// The attention backward kernels (attention_bwd.cu) at head dim 32: the
// towers of the learned-retrieval example (examples_torch/, hidden 128 in 4
// heads). Built in a source of their own so that nvcc compiles them beside
// attention_bwd.cu's; attention_bwd.cu dispatches here.
#include "attention_bwd.cuh"

namespace attn_bwd {
ISX_ATTN_BWD_HD(, 32)
}  // namespace attn_bwd
