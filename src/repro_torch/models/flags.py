"""Model flags of the port (mirrors `repro.models.flags`).

ATTN_IMPL:
  "naive" - einsum + full [B, H, S, S] score tensor (the reference's XLA
            path, the default);
  "flash" - the hand-written flash kernel (`kernels.ops.flash_attention`).

The reference's "chunked" XLA online softmax (`_chunked_attention`) is not
ported yet (ROADMAP.md, Queue 1 item 8) and raises.  Its other flags,
MESH, SEQ_SPLIT_ATTN and UNROLL_LAYERS, steer GSPMD sharding and the HLO
of the layer scan; one eager card has no counterpart of either.
"""

ATTN_IMPL = "naive"
