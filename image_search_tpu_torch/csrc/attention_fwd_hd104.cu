// The attention forward kernels (attention.cu) at head dim 104: OpenCLIP bigG's
// vision tower (1664 wide, 16 heads). Built in a source of their own so that
// nvcc compiles them beside attention.cu's; attention.cu dispatches here.
#include "attention_fwd.cuh"

namespace attn_fwd {
ISX_ATTN_FWD_HD(, 104)
}  // namespace attn_fwd
