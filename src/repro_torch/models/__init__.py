"""The LM substrate of the port: the dense decoder family (llama3.2-3b),
its prefill forward and the decode `Engine`.

Mirrors `repro.models`: `layers`, `attention`, `ffn` (GLU), `transformer`
(`init_params`, `forward`, `init_decode_state`, `decode_step`),
`registry` and `decode_engine`.  The model is an `nn.Module` whose
weights keep the reference's names and `[d_in, d_out]` layout
(`repro_torch.bridge.lm_from_numpy` copies the reference's pytree in).
"""
