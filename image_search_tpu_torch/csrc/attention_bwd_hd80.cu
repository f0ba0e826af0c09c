// The attention backward kernels (attention_bwd.cu) at head dim 80: OpenCLIP
// H/14's vision tower (1280 wide, 16 heads). Built in a source of their own
// so that nvcc compiles them beside attention_bwd.cu's; attention_bwd.cu
// dispatches here.
#include "attention_bwd.cuh"

namespace attn_bwd {
ISX_ATTN_BWD_HD(, 80)
}  // namespace attn_bwd
