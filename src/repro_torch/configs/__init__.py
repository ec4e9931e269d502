"""Architecture configs of the port: its own copy of `repro.configs`.

`base` holds the schema (`ArchConfig`, `ShapeConfig`, `SHAPES`); one
module per ported architecture exports CONFIG (the published numbers) and
SMOKE (a reduced config of the same family for CPU tests).  Ported so far:
llama3.2-3b (dense), qwen2-moe-a2.7b and arctic-480b (MoE), zamba2-7b
(hybrid) and xlstm-125m (xLSTM); `models.registry.get` resolves the ids.
"""
