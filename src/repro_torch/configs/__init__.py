"""Architecture configs of the port: its own copy of `repro.configs`.

`base` holds the schema (`ArchConfig`, `ShapeConfig`, `SHAPES`); one
module per ported architecture exports CONFIG (the published numbers) and
SMOKE (a reduced config of the same family for CPU tests): all ten of the
reference's, llama3.2-3b, gemma-7b, starcoder2-3b and chatglm3-6b (dense),
qwen2-moe-a2.7b and arctic-480b (MoE), zamba2-7b (hybrid), xlstm-125m
(xLSTM), internvl2-2b (vlm: a stub vision frontend) and whisper-large-v3
(enc-dec: a stub audio frontend); `models.registry.get` resolves the ids.
`assembly_presets` holds the reference's two assembly plans.
"""
