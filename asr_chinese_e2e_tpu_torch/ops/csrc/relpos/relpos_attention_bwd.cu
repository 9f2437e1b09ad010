// K12: the relative-position instantiation of the tensor-core attention
// backward (fused_attention_bwd.cu, RELPOS), with its own C entry point
// asr_relpos_attention_bwd; built with K11 (relpos_attention_fwd.cu).
#define ASR_RELPOS_ENTRY
#include "../fused_attention_bwd.cu"
