// The attention forward kernels (attention.cu) at head dim 80: OpenCLIP H/14's
// vision tower (1280 wide, 16 heads). Built in a source of their own so that
// nvcc compiles them beside attention.cu's; attention.cu dispatches here.
#include "attention_fwd.cuh"

namespace attn_fwd {
ISX_ATTN_FWD_HD(, 80)
}  // namespace attn_fwd
