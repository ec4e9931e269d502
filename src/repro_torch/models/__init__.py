"""The LM substrate of the port: the dense decoder family (llama3.2-3b)
and the hybrid family (zamba2-7b), their prefill forward and the decode
`Engine`.

Mirrors `repro.models`: `layers`, `attention`, `ffn` (GLU), `ssm` (the
Mamba-2 half), `transformer` (`init_params`, `forward`,
`init_decode_state`, `decode_step`), `registry` and `decode_engine`.
The model is an `nn.Module` whose weights keep the reference's names and
`[d_in, d_out]` layout (`repro_torch.bridge.lm_from_numpy` copies the
reference's pytree in).
"""
