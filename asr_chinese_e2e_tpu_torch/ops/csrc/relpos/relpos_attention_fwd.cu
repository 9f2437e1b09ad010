// K11: the relative-position instantiation of the tensor-core attention
// forward (fused_attention_fwd.cu, RELPOS), with its own C entry point
// asr_relpos_attention_fwd. It is built into a library of its own
// (ops/_build.py, variant "relpos") on the first rel-pos call, so a model
// without relative positions neither compiles nor loads it.
#define ASR_RELPOS_ENTRY
#include "../fused_attention_fwd.cu"
