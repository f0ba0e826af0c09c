// The attention backward kernels (attention_bwd.cu) at head dim 104: OpenCLIP
// bigG's vision tower (1664 wide, 16 heads; the contraction padded to 112,
// see attention_tc.cuh). Built in a source of their own so that nvcc compiles
// them beside attention_bwd.cu's; attention_bwd.cu dispatches here.
#include "attention_bwd.cuh"

namespace attn_bwd {
ISX_ATTN_BWD_HD(, 104)
}  // namespace attn_bwd
