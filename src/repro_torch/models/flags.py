"""Model flags of the port (mirrors `repro.models.flags`).

ATTN_IMPL:
  "naive"   - einsum + full [B, H, S, S] score tensor (the reference's XLA
              path, the default);
  "chunked" - online softmax over 512 x 512 blocks in plain torch
              (`attention._chunked_attention`, the reference's XLA one),
              at S >= 1024; shorter sequences take "naive";
  "flash"   - the hand-written flash kernel (`kernels.ops.flash_attention`).

The reference's other flags, MESH, SEQ_SPLIT_ATTN and UNROLL_LAYERS, steer
GSPMD sharding and the HLO of the layer scan; one eager card has no
counterpart of either.
"""

ATTN_IMPL = "naive"
