"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py [--num-pairs N] [--num-genomes G]

Drives the port's assembly paths on one virome-like community (under
`Local`, paths 1-3, under `Mesh(8)`, path 6, and as jobs of the
assembly `JobServer`, path 7): 24 genomes of 10-30 kbp (4 of them
1%-divergent strains), 150k reads of 2 x 150 bp at ~45x mean coverage,
and its LM serving paths at full width with random fp32 weights:
llama3.2-3b (path 4), the hybrid zamba2-7b (path 5), the MoE
qwen2-moe-a2.7b (path 8), xlstm-125m (path 9), the enc-dec
whisper-large-v3 (path 10) and the prefills of gemma-7b, starcoder2-3b,
chatglm3-6b and the vlm internvl2-2b (path 11); and its training path
(path 12): llama3.2-3b at full width and xlstm-125m's `train()`.  The community is sized
so the first round's traversal fits the contig_cap of 4096 that the
reference's (contig, mer) tag space allows with the (17, 21, 25) walk
ladder: with 40 genomes (+4 strains) and 240k reads that traversal finds
5893 chains.

Steps:

  1. card name and power limit (nvidia-smi);
  2. build the eight CUDA kernels' libraries (ssd_scan's two: its
     kernel for heads of P, N <= 64 and its wide kernel), and the latency
     probe's, from src/repro_torch/kernels/csrc (one nvcc each, in
     parallel); every
     kernel's registers, stack frame and spills (-Xptxas -v; it fails if
     sw_extend or seed_probe spills, or if the dht_lookup, mer_walk or
     latency probe kernels spill or keep a stack frame), and the
     flash_attention and
     ssd_scan kernels' tensor-core instructions in the built SASS
     (cuobjdump -sass: HGMMA in the bf16 flash kernel, HMMA in the fp32
     flash kernel, ssd_scan and the wide ssd_scan's product kernels; it
     fails without them);
  3. make the reads (host numpy, timed apart);
  4. path 1, Algorithm 1: `contig_rounds` with run_local_assembly=False,
     launch counts reset just before and read just after: each of
     kmer_extract, dht_lookup, dht_insert and seed_probe must have
     launched; the first round's chains against contig_cap; once more
     under torch.profiler; each of the four kernels against its plain
     PyTorch version on the inputs of its largest call, bit for bit, and
     timed; the plain path (backend "torch") equal to the kernel path;
  5. path 2, `Assembler(plan, Local()).assemble` (local assembly,
     scaffolding, gap closing), counts reset just before and read just
     after: all five kernels launched, mer_walk at least 3 times; per
     stage times (host clock, synchronized, through the hook); per round
     extension, links, scaffolds, closed and open gaps, N50, peak memory;
     a quality floor on the longest scaffolds; once more under
     torch.profiler; each of the five kernels against its plain version
     at its largest call on this path (mer_walk at its extension and its
     gap-closing call, dht_insert at the walk tables and at the other
     tables), bit for bit, timed, with this path's launch counts; the
     plain path equal to the kernel path;
  6. path 3, out of core with gapped alignment: the reads written to a
     FASTQ file and streamed back in batches of 32768
     (`iter_fastq_batches` in a `BatchSource`, checked equal to
     `batches_from_readset`), plan `from_stream(..., gapped_align=True)`,
     `Assembler(plan, Local()).assemble_stream(src)`, counts reset just
     before and read just after: all six kernels launched, sw_extend twice
     per batch of each of the 3 alignment passes; per stage times, stream
     stats, scaffolds, peak memory beside path 2's, the quality floor;
     once more under torch.profiler; each sw_extend call's share of
     pairs with qlen = 0 (reads without a candidate); each kernel against
     its plain version at its largest call on this path (rows
     `<kernel>_stream`);
     the plain path equal to the kernel path; and the streamed run of
     path 2's plan over the same reads equal to path 2's `assemble` in
     scaffold sequences and alive contigs;
  7. path 6, the `Mesh(8)` context (8 shards one after another on the
     card, each on its row block, the owner exchanges as transposes),
     counts reset just before each sub-path and read just after: 6a
     `Assembler(plan8, Mesh(8)).assemble` with path 2's plan at
     num_shards=8: path 2's five kernels launched, per stage times, peak
     memory beside path 2's and `plan.bytes()`, every overflow 0, round
     1's n_kmers and n_contigs equal to path 2's, the verbatim-piece
     share within 0.02 of path 2's, a profiled run, rows
     `<kernel>_mesh`, and the plain path equal to the kernel path; 6b
     `assemble_stream` under `Mesh(8)` from path 3's FASTQ with path 3's
     plan at num_shards=8 and a per-shard pre-combine that fits a
     shard's block of a batch: all six kernels launched, alive and
     scaffold_seqs equal to path 3's, overflow 0, rows
     `<kernel>_mesh_stream`; 6c the profile-HMM scorer (`core.hmm`) on
     the card over path 2's contigs with a profile from a seeded
     200-base window of genome 0 (its wall time and the positions it
     looped over; at least one contig flagged, a seeded random row not;
     flags and scores (1e-4) equal to the CPU run), then
     `assemble(hmm_hit=...)` on the kernels; 6d (run between 6b and 6c)
     `Mesh(8, group=g)` over an NCCL process group of one rank
     (`launch.mesh.make_data_mesh` in this process, the exchanges NCCL
     all-to-alls): 6a's `assemble` and 6b's `assemble_stream` again,
     counts reset just before each and read just after, each equal to
     its 6a or 6b run bit for bit (contigs, alive, scaffold sequences,
     every IterationStats field, the overflow dict, the stream stats),
     the same kernels launched, wall and peak memory beside 6a's and
     6b's, and the NCCL all_to_all, all_gather and all_reduce counted in
     a profiled `assemble`;
  8. small inputs on the card against the same runs on the CPU (all
     paths, `low_memory=True`, and a checkpointed `assemble_stream` whose
     second run resumes every k);
  9. path 7, the assembly JobServer (`repro_torch.serving`) on the card,
     counts reset just before the multiplexed run and read just after:
     one `JobServer(Local())` takes path 2's in-memory job (priority 2),
     path 3's streamed FASTQ job (priority 1) and step 8's small
     `assemble` job, under a budget of path 2's bill plus the small
     job's, so the streamed job waits while the small one backfills (the
     admission order is checked); every job must end DONE (a failed job
     fails the run with its error); all six assembly kernels launched;
     each result equal to its solo run (path 2's `assemble`, path 3's
     `assemble_stream` but `StreamStats.resumed`, the small job's card
     run); each job's `plan.bytes()` bill beside its solo peak, and the
     multiplexed run's peak beside the bills admitted at once; then step
     8's streamed job paused after tick 2 and resumed from its
     checkpoint, and one killed after 4 ticks and recovered by a new
     server over the same journal, each equal to its solo run; and a
     `JobServer(Mesh(8))` whose job (path 6a's plan) equals path 6a;
  10. path 4, the LM serving path: llama3.2-3b (28 layers, d_model 3072,
     3.213 G parameters) built on the card by `init_params` from a seeded
     torch.Generator; `forward(use_kernel=True)` on 2 x 4096 seeded
     tokens, counts reset just before and read just after: flash_attention
     launched once a layer and no other kernel; the plain path
     (`use_kernel=False`) against it (max abs logit difference, argmax);
     once more under torch.profiler, recording the last layer's call;
     flash_attention against its plain version at that call in fp32 and in
     bf16, timed beside SDPA; the decode `Engine` serving 8 seeded prompts
     of 16-128 tokens for 160 greedy steps (steps/s, tokens/s), each
     slot's first token's logits against a prefill of the 8 prompts; 8
     decode steps under torch.profiler; stage times and peak memory;
  11. path 5, the hybrid serving path: zamba2-7b (81 Mamba-2 layers in 13
     groups of 6 and a tail of 3, d_model 3584, 112 SSM heads of
     P = N = 64, one weight-tied shared attention + GLU block with 32
     heads of 112 after every group; 10,872,216,432 parameters, the
     reference's init_params leaves) built on the card from a seeded
     torch.Generator; `forward(use_kernel=True)` on 2 x 4096 seeded
     tokens, counts reset just before and read just after: ssd_scan once
     a Mamba-2 layer (81), flash_attention once a group (13), no other
     kernel; the plain path against it (max abs logit difference <= 5e-3,
     argmax); once more under torch.profiler, recording the last calls;
     ssd_scan against its plain version at that call (|d| <= 2e-4 +
     2e-4 |plain|) and flash_attention at D = 112 in fp32 and bf16
     (SDPA as library_ms), timed; the Engine serving 8 seeded prompts of
     16-128 tokens for up to 160 greedy steps, prefill against decode
     (<= 5e-3), 8 profiled decode steps; a float64 witness: the first 3
     groups (18 Mamba-2 layers, 3 shared-block calls) on the prefill's
     tokens, the kernel and plain paths in fp32 against the plain path in
     float64 (built from the same layers once the rest of the model is
     freed), the kernel path within 2x the plain path's difference;
     stage times and peak memory;
  12. path 8, the MoE serving path (last, once path 5's model is freed):
     qwen2-moe-a2.7b (24 layers, d_model 2048, 16 heads of 128, 60 routed
     experts padded to 64 of d_ff 1408, top-4, 4 shared;
     15,146,256,384 parameters, the reference's init_params leaves, 60.59
     GB fp32) built on the card from a seeded torch.Generator;
     `forward(use_kernel=True)` on 2 x 4096 seeded tokens, counts reset
     just before and read just after: flash_attention once a layer (24)
     and no other kernel; the (token, expert) pairs each layer's dispatch
     drops at capacity; the plain path against it (max abs logit
     difference <= 1e-3, argmax, aux loss), replaying the kernel path's
     expert picks (`Routing`: a near-tie of the k-th and (k+1)-th router
     probabilities turns rounding into another expert; the flips are
     counted and printed); the rows `flash_attention_moe` and `_bf16`
     (SDPA as library_ms); the Engine serving 8 seeded prompts for 160
     greedy steps (ms a step against the weight read and the fp32
     operations of the dense-capacity expert products), each slot's first
     decode logits against a prefill of its prompt alone replaying the
     decode's picks (<= 1e-3); 8 profiled decode steps; stage times and
     peak memory;
  13. path 9, the xLSTM serving path (last): xlstm-125m (6 pairs of an
     mLSTM and an sLSTM block, d_model 768, 4 mLSTM heads of P = N = 192;
     123,320,064 parameters, the reference's init_params leaves) built on
     the card from a seeded torch.Generator; `forward(use_kernel=True)` on
     2 x 4096 seeded tokens, counts reset just before and read just after:
     the wide ssd_scan once an mLSTM block (6) and no other kernel; the
     plain path against it (max abs logit difference <= 1e-3, argmax),
     unless a float64 run of the whole model shows the plain path further
     off, when the kernel path must be within 2x the plain path's
     distance to it; the sLSTM loop's share of the prefill's wall (host
     clock, synchronized around each sLSTM block); a profiled prefill of
     2 x 512 tokens: the device busy share and the sLSTM loop's share of
     the wall and of the kernel launches; the row `ssd_scan_xlstm`
     (ssd_scan against its plain version at the prefill's last call) and
     `ssd_scan_xlstm_long` (the same kernel alone at long_500k's length,
     B 1, S 524,288, H 4, P = N = 192, on the mLSTM's input distribution
     at init), each within |d| <= 2e-4 + 2e-4 |plain|, timed, with the
     device time of each of the wide kernel's launches (CUDA events around
     each inside the library's call) and the bytes its design moves
     (inputs and y once, the carried states written once and read once,
     apart) beside the bound; the Engine
     serving 8 seeded prompts for 160 greedy steps, prefill against decode
     (<= 1e-3); 8 profiled decode steps; stage times and peak memory;
  14. path 10, the enc-dec serving path: whisper-large-v3 (32 encoder and
     32 decoder layers, d_model 1280, 20 heads of 64, learned positions;
     2,106,242,560 parameters, the reference's init_params leaves) built
     on the card from a seeded torch.Generator; `encdec.forward(
     use_kernel=True)` on input_specs(prefill_32k) cut to B = 2: frames
     [2, 1500, 1280] and tokens [2, 4096], counts reset just before and
     read just after: flash_attention once a decoder layer (32) and no
     other kernel; the plain path against it (max abs logit difference
     <= 1e-3, argmax); `encode` once more under ATTN_IMPL="flash": 32
     non-causal launches at S = 1500, its states against the naive
     encoder's (<= 1e-3); `decode_step` with `encode`'s output written
     into the fp32 state against the teacher-forced forward at each of the
     first 64 positions (<= 1e-3); the rows `flash_attention_whisper`
     (the last decoder layer's call) and `flash_attention_whisper_enc`
     (the last encoder layer's, non-causal), fp32 and bf16, SDPA as
     library_ms; the Engine serving 8 seeded prompts for 160 greedy steps
     after the caller writes `encode` of 8 seeded frame sets into its
     `enc_out` (the engine takes no audio), prefill against decode
     (<= 1e-3); 8 profiled decode steps; stage times and peak memory;
  15. path 11, the registry's last dense and vlm architectures, one after
     another, each freed before the next: gemma-7b (28 layers, 16 heads of
     256 over d_model 3072, GeGLU, tied), starcoder2-3b (30 layers, 24
     heads over 2 KV heads of 128), chatglm3-6b (28 layers, 32 heads over
     2 KV heads of 128, rotary on half of each head) and internvl2-2b (24
     layers, the stub vision frontend's 256 rows prepended to 3840
     tokens), each at full width (the reference's init_params leaves)
     from a seeded torch.Generator; `forward(use_kernel=True)` on
     input_specs of 2 x 4096, counts reset just before and read just
     after: flash_attention once a layer (28 / 30 / 28 / 24) and no other
     kernel; the plain path against it (<= 1e-3, argmax); starcoder2's
     prefill once more under ATTN_IMPL="chunked" (512 x 512 blocks in
     plain torch) against the naive path (<= 1e-3); gemma's once more
     under torch.profiler; the rows `flash_attention_<model>` and `_bf16`
     at each model's last call (D 256; GQA 12:1; GQA 16:1; 16 heads over
     8), SDPA as library_ms; stage times and peak memory;
  16. path 12, training (last; it runs no kernel, as the training forward
     is the plain path, the reference's too: counts reset just before each
     sub-path and read just after, every kernel at 0): 12a llama3.2-3b
     at full width (3,212,749,824 parameters, tied) from a seeded
     torch.Generator, `launch.train_step` (loss_fn's forward, backward,
     apply_updates: the step `launch.train` runs) on 8 batches of
     TrainConfig's B 8 x S 128 from `synthetic_token_stream`, with fp32
     and then int8 moments: step 1's loss against a no-grad forward
     (1e-6 relative), every step's loss and global norm finite, the last
     loss below the first, the embedding's and layer 0's wq's update at
     step 2 against the same update on the CPU (1e-6; int8 moments within
     one quantum), ms a step split into forward, backward and
     apply_updates (CUDA events), tokens/s, peak memory, 2 profiled steps;
     then a float64 witness 2 layers deep at full width (each fp32
     gradient leaf within 1e-3 of its max |g| from float64); 12b
     `launch.train()` at xlstm-125m full width in a $TMPDIR checkpoint
     directory: 6 steps with a checkpoint every 3, a run to 9 that
     resumes at 6 from parameters and moments bit-equal to the first
     run's final ones, and a run that a timer thread's SIGTERM stops
     with a blocking checkpoint of the step it reached; the stragglers
     flagged.

Every profiled run also prints each of the eight ops' device time and
kernel count (the profiler's kernels summed by the library each op
builds), and every dht_insert row its rounds (all in one cooperative
launch) and the keys still pending after round 1; its bytes
bound counts the key lanes of the valid rows only, with the bound that
counts every row's key lanes beside it in the log.  A dht_lookup row
carries its rows, valid rows and slots examined, and its bytes bound
counts what those need (5 n + 8 n_valid + 9 slots + 4; the count every
row's key lanes gave, 13 n + 9 n_valid + 4, beside it in the log).  A
mer_walk row carries its walkers, steps, rounds (the longest walk) and
slots examined, and its bound is a latency bound: rounds times t_RT,
one dependent round trip to device memory, which a one-thread pointer
chase (csrc/latency_probe.cu) measures on its own log line over a buffer
as large as the walk's tables; the bytes bound stays beside it
(`bytes_bound_ms`).  Both rows carry `host_ms`, the op's host time a
call (host clock around a warm call, the card idle before it, no
synchronise), and `ms_passes`, the three passes whose median is `ms`.

Any failure raises (non-zero exit, no result).  The line before the last
is one JSON object with a record per kernel, path and call site (`path`
names the main path whose shapes and launch counts it carries; the
flash_attention rows of a path, fp32 and bf16, both carry the kernel's
launches on that path, which runs fp32, and `ssd_scan_xlstm_long` path
9's); the last line is {"ok": true,
"device": {...}}.
Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# name -> (kernel source, TPU kernel it replaces)
KERNELS = {
    "kmer_extract": ("src/repro_torch/kernels/csrc/kmer_extract.cu",
                     "src/repro/kernels/kmer_extract.py:155"),
    "dht_lookup": ("src/repro_torch/kernels/csrc/dht_probe.cu",
                   "src/repro/kernels/dht_probe.py:88"),
    "dht_insert": ("src/repro_torch/kernels/csrc/dht_probe.cu",
                   "src/repro/kernels/dht_probe.py:183"),
    "seed_probe": ("src/repro_torch/kernels/csrc/seed_probe.cu",
                   "src/repro/kernels/seed_probe.py:198"),
    "mer_walk": ("src/repro_torch/kernels/csrc/mer_walk.cu",
                 "src/repro/kernels/mer_walk.py:296"),
    "sw_extend": ("src/repro_torch/kernels/csrc/sw_extend.cu",
                  "src/repro/kernels/sw_extend.py:101"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:62"),
}
# the kernels each main path launches; every other kernel must launch 0
# times on that path
PATH1_KERNELS = ("kmer_extract", "dht_lookup", "dht_insert", "seed_probe")
PATH2_KERNELS = PATH1_KERNELS + ("mer_walk",)
PATH3_KERNELS = PATH2_KERNELS + ("sw_extend",)
PATH4_KERNELS = ("flash_attention",)
PATH5_KERNELS = ("ssd_scan", "flash_attention")
PATH8_KERNELS = ("flash_attention",)
PATH9_KERNELS = ("ssd_scan",)
PATH10_KERNELS = ("flash_attention",)
PATH11_KERNELS = ("flash_attention",)
# the wide ssd_scan (heads of P or N > 64): its own source, the same op
SSD_WIDE_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_wide.cu"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12    # H100 SXM 32-bit rate outside the tensor cores
TENSOR_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# fp32-accurate products on the tensor cores: the dense TF32 rate (495
# TFLOP/s) over the three products of the 3xTF32 split, the least time the
# card could take for fp32 work (the fp32 pipes outside the tensor cores,
# SCALAR_OPS_PER_S, are slower); flash_attention's fp32 kernel and
# ssd_scan run on it
TENSOR_TF32X3_OPS_PER_S = 495e12 / 3
# floor on the aligned read share and on the share of long contigs (or
# scaffold pieces) that are verbatim genome substrings: a sanity gate
# against garbage, not a target
MIN_QUALITY = 0.5
DEFAULT_PAIRS, DEFAULT_GENOMES = 75_000, 20
STREAM_BATCH = 32768  # reads per streamed batch on path 3
# path 4, the LM serving path
LM_ARCH = "llama3.2-3b"
LM_DEVICE = "cuda"
LM_SEED = 15
PREFILL_B, PREFILL_S = 2, 4096   # CUT from prefill_32k's 32 x 32768
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW_TOKENS = 8, 512, 160
PROMPT_LENS = (16, 128)
# the profiler's host time to process 32 decode steps was 45-75 s on paths
# 4, 5 and 8 and 46 s on path 10 (H100 runs), most of a path's wall
PROFILED_DECODE_STEPS = 8
# fp32 logits of two fp32 paths (another attention order, other cuBLAS
# shapes) over 28 layers; the logits of the random model have std ~1
LM_LOGIT_TOL = 1e-3
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
# path 5, the hybrid family
HYBRID_ARCH = "zamba2-7b"
HYBRID_SEED = 17
# the leaves of the reference's init_params at full width (its analytic
# param_count() says 6,770,491,392: it undercounts the B/C projections)
HYBRID_PARAMS = 10_872_216_432
# fp32 logits of two fp32 paths (other summation orders in the scan, the
# attention and cuBLAS) through 81 Mamba-2 layers and 13 shared blocks,
# 94 residual blocks in all; the logits of the random model have std ~1
HYBRID_LOGIT_TOL = 5e-3
# the reference's own Pallas-against-oracle tolerance for the scan
# (tests/test_kernels.py): chunked sums in another order
SSD_TOL = 2e-4
WITNESS_GROUPS = 3  # the float64 witness runs the first 3 groups
# path 6, the Mesh context
MESH_SHARDS = 8  # the reference's Mesh default
MESH_PLAIN_REPS = 5  # its rows time the plain version 5 times, not 20
# the reference's Mesh-vs-Local tolerance on quality
# (tests/test_distributed.py): genome fraction at most 0.02 below
MESH_QUALITY_TOL = 0.02
HMM_SEED, HMM_WINDOW = 23, 200
HMM_DEVICE = "cuda"
HMM_SCORE_TOL = 1e-4
# path 8, the MoE family
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_SEED = 19
# the leaves of the reference's init_params at full width (its analytic
# param_count() says 14,312,538,112: it leaves out the 4 padded experts,
# the routers and the norms)
MOE_PARAMS = 15_146_256_384
# fp32 logits of two fp32 paths through 24 layers, the same expert picks
MOE_LOGIT_TOL = 1e-3
# path 9, the xLSTM family
XLSTM_ARCH = "xlstm-125m"
XLSTM_SEED = 29
# the leaves of the reference's init_params at full width (its analytic
# param_count() says 133,890,048: its 8 d^2 a block overcounts)
XLSTM_PARAMS = 123_320_064
# fp32 logits of two fp32 paths through 6 mLSTM and 6 sLSTM blocks
XLSTM_LOGIT_TOL = 1e-3
XLSTM_PROFILE_S = 512  # the profiled prefill's length (CUT, below)
# one call of the wide scan at long_500k's length
LONG_B, LONG_S, LONG_PLAIN_REPS = 1, 524_288, 3
WIDE_LAUNCH_REPS = 5  # timed calls of the wide scan's launches a row
# path 10, the enc-dec family
WHISPER_ARCH = "whisper-large-v3"
WHISPER_SEED = 31
# the leaves of the reference's init_params at full width (its analytic
# param_count() says 1,810,498,560: it leaves out the cross-attentions,
# both position tables, the norms and the vocabulary pad)
WHISPER_PARAMS = 2_106_242_560
# fp32 logits (and encoder states) of two fp32 paths through 32 encoder
# and 32 decoder layers; decode against the teacher-forced forward
WHISPER_TOL = 1e-3
WHISPER_DECODE_STEPS = 64
# path 11, the registry's last dense and vlm architectures: the leaves of
# the reference's init_params at full width (its param_count() leaves out
# the norms, and internvl2's frontend projection and vocabulary pad)
DENSE_ARCHS = {"gemma-7b": (37, 8_537_680_896),
               "starcoder2-3b": (41, 4_312_980_480),
               "chatglm3-6b": (43, 6_243_454_976),
               "internvl2-2b": (47, 1_893_369_856)}
DENSE_LOGIT_TOL = 1e-3
CHUNKED_ARCH = "starcoder2-3b"  # its prefill runs once more under "chunked"
PROFILED_ARCH = "gemma-7b"  # its prefill runs once more under the profiler
# path 12, training
TRAIN_ARCH = "llama3.2-3b"  # the launcher's default --arch
TRAIN_SEED = 53
TRAIN_PARAMS = 3_212_749_824  # the reference's init_params leaves, tied
TRAIN_STEPS = 8
TRAIN_PROFILED_STEPS = 2
TRAIN_TIMED_FROM = 2  # steps 1-2 warm up (and step 2 is copied out)
# the loss of the step's forward against a no-grad forward: the same ops
TRAIN_LOSS_TOL = 1e-6
# one apply_updates on the card against the same update on the CPU
UPDATE_TOL = 1e-6
GRAD_WITNESS_LAYERS = 2
# an fp32 gradient leaf against float64's, relative to the leaf's max |g|
GRAD_WITNESS_TOL = 1e-3
RESUME_ARCH = "xlstm-125m"  # the reference's own resume-test architecture
RESUME_SEED = 59
SIGTERM_AFTER_S = 3.0


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps=20, warmup=2) -> float:
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class Recorder:
    """Wraps the ops wrappers to keep, per row, the arguments of the
    largest call (by elements of its first tensor; mer_walk by active
    walkers) in a run of a main path, and to count the calls of each row.
    `row(name, args, kw)` names the row of a call: by default the kernel's
    name; a path may split a kernel's calls by call site."""

    def __init__(self, ops, names, row=None):
        self.ops = ops
        self.calls = {}
        self.counts = {}
        self.no_candidate = []  # each sw_extend call's share of qlen == 0
        self.row = row or (lambda name, args, kw: name)
        self.orig = {name: getattr(ops, name) for name in names}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def _wrap(self, name, fn):
        def call(*args, **kw):
            key = self.row(name, args, kw)
            if name == "mer_walk":
                size = int(args[4].sum())
            else:
                size = args[4 if name.startswith("dht") else 0].numel()
            if key not in self.calls or size > self.calls[key][0]:
                self.calls[key] = (size, name, args, {
                    k: v for k, v in kw.items() if k != "backend"})
            self.counts[key] = self.counts.get(key, 0) + 1
            if name == "sw_extend":
                self.no_candidate.append(float((args[2] == 0).float().mean()))
            return fn(*args, **kw)
        return call

    def check_counts(self, launches):
        """The recorded run made the launches of the clean run (the same
        deterministic path), kernel by kernel."""
        per_op = {}
        for key, n in self.counts.items():
            op = self.calls[key][1]
            per_op[op] = per_op.get(op, 0) + n
        want = {op: launches[op] for op in self.orig}
        if per_op != want:
            raise AssertionError(f"recorded run's calls {per_op} != clean "
                                 f"run's launches {want}")


def check_path_kernels(launches, kernels, path):
    """Every kernel of the path launched, and no other kernel did."""
    missing = [n for n in kernels if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {path}: {missing}")
    stray = {n: c for n, c in launches.items() if c and n not in kernels}
    if stray:
        raise AssertionError(f"kernels of another path launched on {path}: "
                             f"{stray}")


def max_abs_err(got, want) -> float:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return float(err)


def walk_work(args, kw, ops) -> dict:
    """Walker steps taken and table slots probed by this walk (the plain
    version counts them; the kernel does the same work)."""
    wt, start_hi, start_lo, contig, active = args
    target_hi = kw.get("target_hi")
    target_lo = kw.get("target_lo")
    if target_hi is None:
        target_hi = torch.zeros_like(start_hi)
        target_lo = torch.zeros_like(start_lo)
    counts = {}
    ops.ref.mer_walk_ref(
        start_hi, start_lo, contig, active, target_hi, target_lo,
        tuple(t.slot_hi for t in wt.tables),
        tuple(t.slot_lo for t in wt.tables), tuple(t.used for t in wt.tables),
        tuple(t.max_probe for t in wt.tables), tuple(wt.right_hist),
        tuple(wt.left_hist), counts=counts,
        **{k: v for k, v in kw.items() if k not in ("target_hi",
                                                    "target_lo")})
    return counts


def round_trip_ns(nbytes, build) -> float:
    """ns of one dependent round trip to device memory: one thread chases
    a random cycle (csrc/latency_probe.cu) of 2^20 nodes spread over a
    buffer of at least `nbytes`, three runs of 2^17 hops timed on the
    device, each going on where the last stopped, so that no node is
    visited twice (a second visit would find its line in the L2)."""
    nodes, hops = 1 << 20, 1 << 17
    stride = 1
    while nodes * stride * 4 < nbytes:
        stride *= 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    order = torch.randperm(nodes, generator=gen, device=dev)
    at = order * stride  # node order[i] lives at word order[i] * stride
    chase = torch.empty((nodes * stride,), dtype=torch.int32, device=dev)
    chase[at] = torch.roll(at, -1).to(torch.int32)
    last = torch.empty((1,), dtype=torch.int32, device=dev)
    ns = torch.empty((1,), dtype=torch.int64, device=dev)
    lib = build.library("latency_probe")
    stream = torch.cuda.current_stream().cuda_stream
    runs, start = [], int(at[0])
    for _ in range(3):
        err = lib.latency_probe_launch(chase.data_ptr(), start, hops,
                                       last.data_ptr(), ns.data_ptr(),
                                       stream)
        if err != 0:
            raise RuntimeError(f"latency_probe failed: "
                               f"{lib.repro_error_string(err).decode()}")
        torch.cuda.synchronize()
        runs.append(int(ns) / hops)
        start = int(last) & 0xFFFFFFFF  # a uint32 index
    if start != int(at[3 * hops % nodes]):
        raise AssertionError("latency_probe: the chase left its cycle")
    t_rt = float(np.median(runs))
    log(f"t_RT: {t_rt:.1f} ns a dependent round trip (median of 3 chases "
        f"of {hops} hops over {nodes} nodes in {chase.numel() * 4} bytes; "
        f"runs {', '.join(f'{r:.1f}' for r in runs)} ns)")
    return t_rt


def bound(name, args, kw, ops, row) -> tuple:
    """(bound_ms, bound_by, fields) of kernel `name`: the larger of bytes
    / HBM rate and operations / scalar rate, for the work these inputs
    need (mer_walk: and its latency bound, the longest walk's steps times
    one dependent round trip); `fields` holds the counts of that work for
    the row's record."""
    fields = {}
    t_lat = 0.0
    if name == "kmer_extract":
        bases, lengths = args
        R, L = bases.shape
        k = kw["k"]
        W = L - k + 1
        nbytes = R * L * (1 + 16) + 4 * R
        nops = R * W * (3 * k + 34)
    elif name == "dht_lookup":
        work = ops.ref.dht_lookup_work(*args)
        nbytes = work["bytes"]
        nops = work["valid"] * 40
        fields = dict(rows=work["rows"], valid_rows=work["valid"],
                      slots_examined=work["slots"])
        every = work["bytes_every_row"]
        log(f"  {row}: {work['rows']} rows, {work['valid']} valid, "
            f"{work['slots']} slots examined: bytes bound 5 n + 8 n_valid "
            f"+ 9 slots + 4 = {nbytes} "
            f"({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); the count it "
            f"replaces, 13 n + 9 n_valid + 4 = {every} "
            f"({every / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    elif name == "dht_insert":
        # valid read once, slots written once, the key lanes of the valid
        # rows only, the table read and the new table written
        cap, n = args[0].numel(), args[4].numel()
        n_valid = int(args[6].sum())
        nbytes = n + 4 * n + 8 * n_valid + 18 * cap + 8
        nops = n_valid * 40
        every_row = 13 * n + 18 * cap + 8  # with every row's key lanes
        log(f"  {row}: {n} rows, {n_valid} valid, cap {cap}: bytes bound "
            f"n + 4 n + 8 n_valid + 18 cap + 8 = {nbytes} "
            f"({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); with every row's "
            f"key lanes 13 n + 18 cap + 8 = {every_row} "
            f"({every_row / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    elif name == "seed_probe":
        bases, lengths = args[0], args[1]
        t = args[2:6]
        R, L = bases.shape
        seed_len, positions = kw["seed_len"], kw["positions"]
        lanes = ops.kmer_extract(bases, lengths, k=seed_len, backend="torch")
        cols = torch.tensor(positions, device=bases.device)
        valid = lanes.valid[:, cols]
        slots = ops.dht_lookup(*t, lanes.hi[:, cols].contiguous(),
                               lanes.lo[:, cols].contiguous(),
                               valid.contiguous(), backend="torch")
        n_valid, n_hit = int(valid.sum()), int((slots >= 0).sum())
        S = len(positions)
        nbytes = R * L + 4 * R + R * 2 * 9 + 9 * n_valid + 10 * n_hit
        nops = R * S * (3 * seed_len + 40) + R * S * S * 4
    elif name == "sw_extend":  # ~10 scalar operations per band cell
        query, target = args[0], args[1]
        B, QL = query.shape
        TL = target.shape[1]
        band = kw.get("band", 15)
        nbytes = B * (QL + TL + 4 + 4) + 3 * 4 * B
        nops = B * QL * (2 * band + 1) * 10
    else:  # mer_walk: per step one 16-byte histogram row, 9 B per slot
        wt = args[0]
        E = args[1].numel()
        work = walk_work(args, kw, ops)
        target = 8 if kw.get("seed_len") else 0
        nbytes = (E * (4 + 4 + 4 + 1 + target)
                  + 9 * work["probes"] + 16 * work["steps"]
                  + E * (kw["max_ext"] + 4 + 4 + 1 + 4))
        nops = 80 * work["steps"] + 8 * work["probes"]
        tables = sum(a.numel() * a.element_size() for t in wt.tables
                     for a in t[:3])
        tables += sum(h.numel() * h.element_size()
                      for h in (*wt.right_hist, *wt.left_hist))
        t_rt = round_trip_ns(tables, ops.build)
        t_lat = work["rounds"] * t_rt * 1e-6
        fields = dict(walkers=E, active=int(args[4].sum()),
                      steps=work["steps"], rounds=work["rounds"],
                      slots_examined=work["probes"], t_rt_ns=t_rt,
                      bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        log(f"  {row}: {E} walkers ({fields['active']} active), "
            f"{work['steps']} steps, {work['rounds']} rounds (the longest "
            f"walk), {work['probes']} slots probed; latency bound rounds x "
            f"t_RT = {work['rounds']} x {t_rt:.1f} ns = {t_lat:.4f} ms, "
            f"bytes bound {fields['bytes_bound_ms']:.4f} ms; tables "
            f"{tables} bytes")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    best = max((t_bytes, "bytes"), (t_ops, "operations"),
               (t_lat, "latency"))
    return (*best, fields)


def host_ms(fn, reps=20) -> float:
    """Median host time of a warm call of fn(), the card idle before each
    and no synchronise inside: the wrapper's work before and around its
    launch."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def hold_against_plain(row, call, ops, launches, path, plain_reps=20):
    """The kernel against its plain version on one recorded call: equal
    bit for bit, both timed (the plain version a median of `plain_reps`);
    returns the row's JSON record.  dht_lookup and mer_walk rows also
    carry the op's host time a call, and their kernel time is the median
    of three passes, each a median of 20, with the passes beside it
    (`ms_passes`): their calls are short, and one pass can move by a
    tenth."""
    _, name, cargs, ckw = call
    source, replaces = KERNELS[name]
    fn = getattr(ops, name)
    if name == "dht_lookup" and (len(cargs) < 7 or cargs[6] is None):
        q = cargs[4]  # every query valid, as the op takes it
        cargs = (*cargs[:6], torch.ones(q.shape, dtype=torch.bool,
                                        device=q.device))
    got = fn(*cargs, **ckw)
    want = fn(*cargs, **ckw, backend="torch")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    extra = {}
    if name == "dht_insert":  # the kernel's own counters
        c = ops.LAST_INSERT
        extra = dict(valid_keys=c["valid"], rounds=c["rounds"],
                     pending_after_round_1=c["pending_after_round_1"])
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{row}: kernel != plain version "
                             f"(max abs err {err})")
    del got, want
    if name == "dht_insert":
        log(f"  {row}: {extra['valid_keys']} valid keys, "
            f"{extra['rounds']} rounds in one launch, "
            f"{extra['pending_after_round_1']} keys pending after round 1")
    if name in ("dht_lookup", "mer_walk"):
        extra["ms_passes"] = [median_ms(lambda: fn(*cargs, **ckw))
                              for _ in range(3)]
        ms = float(np.median(extra["ms_passes"]))
    else:
        ms = median_ms(lambda: fn(*cargs, **ckw))
    plain_ms = median_ms(lambda: fn(*cargs, **ckw, backend="torch"),
                         reps=plain_reps)
    b_ms, b_by, fields = bound(name, cargs, ckw, ops, row)
    extra.update(fields)
    if name in ("dht_lookup", "mer_walk"):
        extra["host_ms"] = host_ms(lambda: fn(*cargs, **ckw))
        note = (f"; host {extra['host_ms']:.4f} ms a call; kernel ms in "
                f"3 passes " + ", ".join(f"{t:.4f}"
                                         for t in extra["ms_passes"]))
        log(f"  {row}: {b_ms / ms:.3f} of the bound ({ms / b_ms:.2f}x)"
            + note)
    shapes = [tuple(a.shape) for a in cargs if torch.is_tensor(a)]
    log(f"{row}: equal to plain (tolerance 0), inputs {shapes}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return dict(
        name=row, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, path=path, **extra)


def n50(lengths) -> int:
    ls = np.sort(np.asarray(lengths))[::-1]
    if not len(ls):
        return 0
    c = np.cumsum(ls)
    return int(ls[np.searchsorted(c, c[-1] / 2)])


def run_rounds(Assembler, Local, plan, reads, label):
    """contig_rounds with per-round wall times (synchronized)."""
    asm = Assembler(plan, Local())
    gen = asm.contig_rounds_iter(reads)
    times = []
    t0 = time.perf_counter()
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            out = stop.value
            break
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        t0 = t1
    for s, t in zip(out[3], times):
        log(f"[{label}] round k={s.k}: {t:.3f} s, n_kmers={s.n_kmers}, "
            f"n_contigs={s.n_contigs}, aligned_frac={s.aligned_frac:.4f}, "
            f"bubbles={s.n_bubbles}, hair={s.n_hair}, pruned={s.n_pruned}, "
            f"overflow={s.overflow}")
    return out, times, asm.ctx.overflow()


def assemble_label(stage, info):
    """Path 2's stage names: one event per stage and round."""
    return f"{stage} k={info['k']}" if "k" in info else stage


def stream_label(stage, info):
    """Path 3's stage names, under which the per-batch events add up."""
    k = info.get("k")
    if stage == "analyze":
        return f"k={k} two-pass analysis (+ contig k-mer merge)"
    if stage == "contig_rounds" and "batch" in info:
        return f"k={k} graph, seed index, alignment pass + walk tables"
    if stage == "contig_rounds":
        return f"k={k} local assembly walk"
    if stage == "align":
        return "final alignment pass + walk tables + witnesses"
    return stage


class StageClock:
    """Hook of `assemble` / `assemble_stream`: synchronized host time and
    launches of `kernel` by stage, summed over the events of one label.
    Each interval is named by the event that ends it; the last one, gap
    closing, ends when the run returns."""

    def __init__(self, ops, kernel, label):
        self.ops = ops
        self.kernel = kernel
        self.label = label
        self.stages = {}

    def start(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.w0 = self.ops.LAUNCHES[self.kernel]

    def __call__(self, stage, info):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        w1 = self.ops.LAUNCHES[self.kernel]
        name = self.label(stage, info)
        t, w = self.stages.get(name, (0.0, 0))
        self.stages[name] = (t + t1 - self.t0, w + w1 - self.w0)
        self.t0, self.w0 = t1, w1

    def finish(self):
        self("gap_closing", {})

    def launches(self, prefix="") -> int:
        return sum(w for name, (_, w) in self.stages.items()
                   if name.startswith(prefix))


def run_clocked(run, clock, label, what):
    """run(hook) with per-stage wall times (synchronized, via the hook)."""
    clock.start()
    out = run(clock)
    clock.finish()
    for name, (t, w) in clock.stages.items():
        log(f"[{label}] stage {name}: {t:.3f} s, {clock.kernel} launches "
            f"{w}")
    log(f"[{label}] {what} total: "
        f"{sum(t for t, _ in clock.stages.values()):.3f} s")
    return out, clock


def run_assemble(Assembler, Local, plan, reads, ops, label):
    return run_clocked(
        lambda hook: Assembler(plan, Local()).assemble(reads, hook=hook),
        StageClock(ops, "mer_walk", assemble_label), label, "assemble")


# kernel function name -> the op whose library builds it (`kernel_ops`)
KERNEL_OPS: dict = {}


def kernel_ops(build) -> dict:
    """{kernel function: op}: every kernel each op's library builds (its
    -Xptxas -v report, kept beside the library, so a build from an
    earlier process counts too), dht_probe's split between dht_lookup and
    dht_insert by name."""
    names = {}
    for lib, text in build.last_build().get("logs", {}).items():
        for fn in build.ptxas_report(text):
            m = re.search(r"(\w+_kernel)\b", fn)
            if not m:
                continue
            op = lib
            if lib == "latency_probe":  # measures; no op of the port
                continue
            if lib == "dht_probe":
                op = "dht_lookup" if "lookup" in m.group(1) else "dht_insert"
            if lib == "ssd_scan_wide":  # ops.ssd_scan's kernel for wide heads
                op = "ssd_scan"
            names[m.group(1)] = op
    missing = [op for op in KERNELS if op not in names.values()]
    if missing:
        raise AssertionError(f"no kernel names for {missing} in the build "
                             f"report")
    return names


def profile(fn, title, top=12):
    """Device time over one call of fn(): the device's busy share of the
    wall time (one stream, so kernels do not overlap), each of the eight
    ops' device time and kernel count (the profiler's kernels summed by
    the library each op builds), then the kernels and the PyTorch
    operators that take the most of it.  Returns the profile and the
    wall time (s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # a record_function range also shows on the device's timeline: no kernel
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"profiled {title}: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%)")
    per_op = {op: [0.0, 0] for op in KERNELS}
    for e in kernels:
        m = re.search(r"(\w+_kernel)\b", e.key)
        op = KERNEL_OPS.get(m.group(1)) if m else None
        if op:
            per_op[op][0] += e.self_device_time_total / 1e3
            per_op[op][1] += e.count
    log(f"  the eight ops' device time in {title}: " + "; ".join(
        f"{op} {ms:.3f} ms in {n} kernels" for op, (ms, n) in
        per_op.items()))
    operators = [e for e in events if e.device_type == DeviceType.CPU
                 and e.self_device_time_total > 0]
    for name, rows in (("kernels", kernels), ("operators", operators)):
        log(f"  top {name} by device time:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"  {e.self_device_time_total / 1e3:10.2f} ms "
                f"{e.count:7d} calls  {e.key[:100]}")
    return prof, wall


def assert_same(a, b, what):
    la = a if isinstance(a, tuple) else (a,)
    lb = b if isinstance(b, tuple) else (b,)
    if len(la) != len(lb):
        raise AssertionError(f"{what} differ")
    for x, y in zip(la, lb):
        if x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what} differ")


ASSEMBLE_KEYS = ("contigs", "alive", "alignments", "links", "suspended",
                 "components", "scaffolds", "scaffold_seqs")


def assert_same_assembly(a, b, what):
    for key in ASSEMBLE_KEYS:
        assert_same(a[key], b[key], f"{what}: {key}")
    if a["stats"] != b["stats"]:
        raise AssertionError(f"{what}: stats differ")


def _genome_texts(comm):
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    return ([g.tobytes() for g in comm.genomes]
            + [comp[g[::-1]].tobytes() for g in comm.genomes])


def genome_matches(contigs, alive, comm, top=200) -> float:
    """Share of the `top` longest live contigs found verbatim in a genome
    (either strand)."""
    lens = contigs.lengths.cpu().numpy() * alive.cpu().numpy()
    order = np.argsort(lens)[::-1][:top]
    order = order[lens[order] > 0]
    if not len(order):
        return 0.0
    genomes = _genome_texts(comm)
    bases = contigs.bases[torch.from_numpy(order.copy()).to(
        contigs.bases.device)].cpu().numpy()
    hits = sum(any(bases[i, :lens[c]].tobytes() in g for g in genomes)
               for i, c in enumerate(order))
    return hits / len(order)


def scaffold_piece_matches(seqs, comm, top=200) -> tuple:
    """Split the `top` longest scaffolds at their N runs; (share of the
    pieces found verbatim in a genome, number of pieces)."""
    lens = seqs.lengths.cpu().numpy()
    order = np.argsort(lens)[::-1][:top]
    order = order[lens[order] > 0]
    genomes = _genome_texts(comm)
    bases = seqs.bases[torch.from_numpy(order.copy()).to(
        seqs.bases.device)].cpu().numpy()
    pieces = []
    for i, s in enumerate(order):
        row = bases[i, :lens[s]]
        edge = np.diff(np.r_[0, (row < 4).astype(np.int8), 0])
        for a, b in zip(np.flatnonzero(edge == 1),
                        np.flatnonzero(edge == -1)):
            pieces.append(row[a:b].tobytes())
    if not pieces:
        return 0.0, 0
    hits = sum(any(p in g for g in genomes) for p in pieces)
    return hits / len(pieces), len(pieces)


def phase_contig_rounds(api, ops, dbg, reads, comm):
    """Path 1: Algorithm 1 (no local assembly) on the four slice-1 kernels.
    Returns the JSON records of the four kernels."""
    Assembler, AssemblyPlan, Local = api
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.1,
                                     run_local_assembly=False)
    log(f"path 1 plan: ks={plan.ks()} kmer_capacity={plan.kmer_capacity} "
        f"seed_cap={plan.seed_cap} contig_cap={plan.contig_cap} "
        f"max_contig_len={plan.max_contig_len} "
        f"plan.bytes()={plan.bytes() / 1e9:.2f} GB")

    # ---- main path with the kernels (clean: no recorder, no profiler) ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (contigs, alive, al, stats), times, ovf = run_rounds(
        Assembler, Local, plan, reads, "kernels")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in contig_rounds: {launches}")
    log(f"peak device memory: {peak / 1e9:.2f} GB; overflow: {ovf}")
    check_path_kernels(launches, PATH1_KERNELS, "path 1")
    if ovf.get("kmer_table"):
        raise AssertionError(f"k-mer table overflow: {ovf}")
    live = alive.cpu().numpy()
    clens = contigs.lengths.cpu().numpy()[live]
    if not (live.sum() > 0 and torch.isfinite(contigs.depths).all()
            and contigs.bases.shape == (plan.contig_cap, plan.max_contig_len)
            and al.contig.shape == (reads.num_reads, 2)):
        raise AssertionError("contig_rounds output has the wrong shape or "
                             "non-finite depths")
    frac = genome_matches(contigs, alive, comm)
    log(f"contigs: {int(live.sum())} live, {int(clens.sum())} bp, "
        f"N50 {n50(clens)}, longest {int(clens.max())}; "
        f"aligned_frac {stats[-1].aligned_frac:.4f}; "
        f"{frac:.3f} of the 200 longest are verbatim genome substrings")
    if stats[-1].aligned_frac < MIN_QUALITY or frac < MIN_QUALITY:
        raise AssertionError("assembly quality collapsed")

    # ---- the traversal's overflow flag, first round: more chains than
    # contig_cap, or a chain longer than max_contig_len? ----
    ctx = Local()
    ctx.prepare(reads, plan)
    kset, _ = ctx.kmer_set(plan.k_min, None)
    trav = dbg.traverse(kset, dbg.build_index(kset), k=plan.k_min,
                        contig_cap=plan.contig_cap,
                        max_len=plan.max_contig_len)
    n_chains = int(trav.n_contigs)
    log(f"round k={plan.k_min} traversal: {n_chains} chains "
        f"(contig_cap {plan.contig_cap}), longest "
        f"{int(trav.node_pos.max()) + plan.k_min} bp (max_contig_len "
        f"{plan.max_contig_len})")
    del ctx, kset, trav
    if n_chains > plan.contig_cap:
        raise AssertionError("the community overflows contig_cap: lower "
                             "--num-genomes")

    # ---- where the time goes: one profiled run ----
    profile(lambda: Assembler(plan, Local()).contig_rounds(reads),
            "contig_rounds")

    # ---- the inputs of each kernel's largest call (a warm run) ----
    with Recorder(ops, PATH1_KERNELS) as rec:
        t0 = time.perf_counter()
        Assembler(plan, Local()).contig_rounds(reads)
        torch.cuda.synchronize()
        log(f"warm contig_rounds (recording inputs): "
            f"{time.perf_counter() - t0:.3f} s")
    rec.check_counts(launches)

    # ---- each kernel against its plain version, at the path's shapes ----
    records = [hold_against_plain(name, rec.calls[name], ops,
                                  launches[name], "contig_rounds")
               for name in PATH1_KERNELS]
    del rec

    # ---- the same path with the plain versions on the card ----
    plain_plan = dataclasses.replace(plan, kernel_backend="torch")
    ops.reset_launches()
    (p_contigs, p_alive, p_al, p_stats), p_times, _ = run_rounds(
        Assembler, Local, plain_plan, reads, "plain")
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain run launched kernels: {ops.LAUNCHES}")
    assert_same(contigs, p_contigs, "contigs (kernels vs plain)")
    assert_same(alive, p_alive, "alive (kernels vs plain)")
    assert_same(al, p_al, "alignments (kernels vs plain)")
    if [dataclasses.asdict(s) for s in stats] != \
            [dataclasses.asdict(s) for s in p_stats]:
        raise AssertionError("iteration stats differ (kernels vs plain)")
    log(f"plain path: identical contigs, alive, alignments, stats; "
        f"{sum(p_times):.3f} s vs kernels {sum(times):.3f} s")
    return records


def assemble_row(plan):
    """Rows of path 2's kernel calls: `<kernel>_assemble`, with mer_walk
    split into its extension and gap-closing walks and the walk-table
    inserts (the tables at `walk_capacity`) apart from the other inserts."""
    if plan.walk_capacity in (plan.kmer_capacity, plan.seed_cap):
        raise AssertionError("walk tables share a capacity with another "
                             "table: their inserts cannot be told apart")

    def row(name, args, kw):
        if name == "mer_walk":
            return "mer_walk_gap" if kw.get("seed_len") else \
                "mer_walk_extend"
        if name == "dht_insert" and args[0].numel() == plan.walk_capacity:
            return "dht_insert_walk"
        return f"{name}_assemble"
    return row


def phase_assemble(api, ops, reads, comm):
    """Path 2: `assemble` with local assembly, scaffolding and gap
    closing.  Returns the JSON records of its kernel rows (each of the
    five kernels of PATH2_KERNELS at its largest call on this path) and
    what path 3 compares with."""
    Assembler, AssemblyPlan, Local = api
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.1)
    log(f"path 2 plan: ks={plan.ks()} ladders "
        f"{[plan.ladder(k) for k in plan.ks()]} contig_cap="
        f"{plan.contig_cap} walk_capacity={plan.walk_capacity} "
        f"link_capacity={plan.link_capacity} max_members="
        f"{plan.max_members} max_scaffold_len={plan.max_scaffold_len} "
        f"plan.bytes()={plan.bytes() / 1e9:.2f} GB")

    # ---- main path with the kernels (clean: no recorder, no profiler) ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, clock = run_assemble(Assembler, Local, plan, reads, ops, "kernels")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in assemble: {launches}")
    log(f"peak device memory (assemble): {peak / 1e9:.2f} GB; overflow: "
        f"{out['overflow']}")
    check_path_kernels(launches, PATH2_KERNELS, "path 2")
    if launches["mer_walk"] < 3:
        raise AssertionError(f"mer_walk launched {launches['mer_walk']} "
                             f"times, expected 2 extension + 1 gap walks")
    walks_extend = clock.launches("contig_rounds")
    walks_gap = clock.launches("gap_closing")
    if walks_extend + walks_gap != launches["mer_walk"] or not (
            walks_extend and walks_gap):
        raise AssertionError(f"mer_walk launches by stage: {clock.stages}")
    for s in out["stats"]:
        log(f"[kernels] round k={s.k}: n_contigs={s.n_contigs} live, "
            f"extended_bases={s.extended_bases}, n_kmers={s.n_kmers}, "
            f"aligned_frac={s.aligned_frac:.4f}, overflow={s.overflow}")
    if out["overflow"].get("kmer_table"):
        raise AssertionError(f"k-mer table overflow: {out['overflow']}")
    scaffs, seqs, links = out["scaffolds"], out["scaffold_seqs"], out["links"]
    nm = scaffs.n_members
    n_gaps = int((nm - 1).clamp(min=0).sum())
    closed = int(seqs.closed.sum())
    slens = seqs.lengths.cpu().numpy()
    slens = slens[slens > 0]
    share, n_pieces = scaffold_piece_matches(seqs, comm)
    if not (len(slens) and torch.isfinite(links.gap).all()
            and seqs.bases.shape == (plan.contig_cap, plan.max_scaffold_len)
            and torch.isfinite(out["contigs"].depths).all()):
        raise AssertionError("assemble output has the wrong shape, no "
                             "scaffold or non-finite values")
    log(f"scaffolds: {int(scaffs.n_scaffolds)}, multi-contig "
        f"{int((nm >= 2).sum())}, links {int(links.valid.sum())} valid, "
        f"suspended {int(out['suspended'].sum())}, gaps closed {closed} / "
        f"open {n_gaps - closed}; scaffold N50 {n50(slens)}, longest "
        f"{int(slens.max())}, {int(slens.sum())} bp; {share:.3f} of "
        f"{n_pieces} pieces (the 200 longest scaffolds split at N runs) "
        f"are verbatim genome substrings")
    if share < MIN_QUALITY:
        raise AssertionError("scaffold quality collapsed")

    # ---- where the time goes: one profiled run ----
    profile(lambda: Assembler(plan, Local()).assemble(reads), "assemble")

    # ---- the inputs of each row's largest call (a warm run) ----
    with Recorder(ops, PATH2_KERNELS, assemble_row(plan)) as rec:
        t0 = time.perf_counter()
        Assembler(plan, Local()).assemble(reads)
        torch.cuda.synchronize()
        log(f"warm assemble (recording inputs): "
            f"{time.perf_counter() - t0:.3f} s")
    rec.check_counts(launches)
    if (rec.counts["mer_walk_extend"], rec.counts["mer_walk_gap"]) != \
            (walks_extend, walks_gap):
        raise AssertionError(f"mer_walk calls by site {rec.counts} != "
                             f"launches by stage {clock.stages}")
    log(f"calls by row in assemble: {rec.counts}")

    # ---- each kernel against its plain version, at this path's shapes;
    # launches: the clean run's, split by row as the recorded run's ----
    records = [hold_against_plain(row, rec.calls[row], ops, n, "assemble")
               for row, n in rec.counts.items()]
    del rec

    # ---- the same path with the plain versions on the card ----
    plain_plan = dataclasses.replace(plan, kernel_backend="torch")
    ops.reset_launches()
    p_out, p_clock = run_assemble(Assembler, Local, plain_plan, reads, ops,
                                  "plain")
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain run launched kernels: {ops.LAUNCHES}")
    assert_same_assembly(out, p_out, "assemble (kernels vs plain)")
    log("plain path: identical " + ", ".join(ASSEMBLE_KEYS) + ", stats")
    # what path 3 holds its streamed run of this plan against, on the host
    path2 = dict(plan=plan, peak=peak, alive=out["alive"].cpu(),
                 contigs=type(out["contigs"])(*(x.cpu()
                                                for x in out["contigs"])),
                 scaffold_seqs=type(seqs)(*(x.cpu() for x in seqs)),
                 stats=out["stats"], share=share,
                 wall=sum(t for t, _ in clock.stages.values()))
    return records, path2


def write_fastq(reads, path):
    """The reads as FASTQ, in their order (interleaved pairs r1, r2),
    every quality 'I' (q40, so no base is trimmed)."""
    bases = reads.bases.cpu().numpy()
    lengths = reads.lengths.cpu().numpy()
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        f.writelines(
            f"@read{i // 2}/{i % 2 + 1}\n"
            f"{letters[bases[i, :lengths[i]]].tobytes().decode()}\n+\n"
            f"{'I' * int(lengths[i])}\n" for i in range(len(bases)))


def run_stream(Assembler, Local, plan, src, ops, label):
    return run_clocked(
        lambda hook: Assembler(plan, Local()).assemble_stream(src,
                                                              hook=hook),
        StageClock(ops, "sw_extend", stream_label), label, "assemble_stream")


def assert_same_stream(a, b, what):
    assert_same_assembly(a, b, what)
    if a["stream_stats"] != b["stream_stats"]:
        raise AssertionError(f"{what}: stream_stats differ")


def phase_stream(api, ops, reads, comm, path2, tmp):
    """Path 3: out-of-core `assemble_stream` from a FASTQ file (written to
    the directory `tmp`) with gapped alignment.  Returns the JSON records
    of its kernel rows and what path 6b compares with."""
    Assembler, AssemblyPlan, Local = api
    from repro_torch.data.fastq import iter_fastq_batches
    from repro_torch.stream import BatchSource, batches_from_readset

    fq = os.path.join(tmp, "reads.fq")
    t0 = time.perf_counter()
    write_fastq(reads, fq)
    log(f"path 3 FASTQ: {reads.num_reads} reads, "
        f"{os.path.getsize(fq) / 1e6:.1f} MB, written in "
        f"{time.perf_counter() - t0:.2f} s")
    src = BatchSource(lambda: iter_fastq_batches(
        fq, batch_reads=STREAM_BATCH, max_len=reads.max_len,
        insert_size=reads.insert_size))
    t0 = time.perf_counter()
    fq_batches = list(src)
    parse_s = time.perf_counter() - t0
    ref_batches = batches_from_readset(reads, STREAM_BATCH)
    if len(fq_batches) != len(ref_batches):
        raise AssertionError("FASTQ batches != batches_from_readset")
    for a, b in zip(fq_batches, ref_batches):
        for f in ("bases", "lengths", "mate"):
            if not torch.equal(getattr(a, f), getattr(b, f).cpu()):
                raise AssertionError(f"FASTQ batch {f} differs from "
                                     f"batches_from_readset")
    n_batches = len(fq_batches)
    del fq_batches, ref_batches
    log(f"path 3 source: {n_batches} batches of {STREAM_BATCH} reads "
        f"(the last padded), equal to batches_from_readset; one pass "
        f"of the host FASTQ parse: {parse_s:.2f} s")
    content = sum(len(g) for g in comm.genomes)
    plan = AssemblyPlan.from_stream(STREAM_BATCH, reads.max_len,
                                    (17, 21, 4), unique_kmers=content,
                                    gapped_align=True)
    log(f"path 3 plan: from_stream(unique_kmers={content}, gapped_align"
        f"=True): kmer_capacity={plan.kmer_capacity} bloom_slots="
        f"{plan.bloom_slots} walk_capacity={plan.walk_capacity} "
        f"contig_cap={plan.contig_cap} max_contig_len="
        f"{plan.max_contig_len} plan.bytes()={plan.bytes() / 1e9:.2f} GB "
        f"(path 2: {path2['plan'].bytes() / 1e9:.2f} GB)")

    # ---- main path with the kernels (clean: no recorder, profiler) --
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, clock = run_stream(Assembler, Local, plan, src, ops, "kernels")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in assemble_stream: {launches}")
    log(f"peak device memory (assemble_stream): {peak / 1e9:.2f} GB "
        f"(path 2 assemble: {path2['peak'] / 1e9:.2f} GB); overflow: "
        f"{out['overflow']}")
    check_path_kernels(launches, PATH3_KERNELS, "path 3")
    want_sw = 3 * n_batches * 2
    if launches["sw_extend"] != want_sw or clock.launches() != want_sw:
        raise AssertionError(f"sw_extend launched {launches['sw_extend']}"
                             f" times, expected {want_sw}: "
                             f"{clock.stages}")
    if out["overflow"].get("kmer_table"):
        raise AssertionError(f"k-mer table overflow: {out['overflow']}")
    for s in out["stats"]:
        st = out["stream_stats"][s.k]
        log(f"[kernels] round k={s.k}: n_kmers={s.n_kmers}, n_contigs="
            f"{s.n_contigs}, extended_bases={s.extended_bases}, "
            f"aligned_frac={s.aligned_frac:.4f}; stream: "
            f"{st.occurrences_admitted}/{st.occurrences_total} "
            f"occurrences admitted ({st.admitted_frac:.4f}), batches "
            f"{st.batches_pass1}+{st.batches_pass2}")
    scaffs, seqs, links = out["scaffolds"], out["scaffold_seqs"], \
        out["links"]
    nm = scaffs.n_members
    n_gaps = int((nm - 1).clamp(min=0).sum())
    closed = int(seqs.closed.sum())
    slens = seqs.lengths.cpu().numpy()
    slens = slens[slens > 0]
    share, n_pieces = scaffold_piece_matches(seqs, comm)
    if not (len(slens) and torch.isfinite(links.gap).all()
            and seqs.bases.shape == (plan.contig_cap,
                                     plan.max_scaffold_len)
            and out["alignments"].contig.shape == (
                n_batches * STREAM_BATCH, 2)
            and torch.isfinite(out["contigs"].depths).all()):
        raise AssertionError("assemble_stream output has the wrong "
                             "shape, no scaffold or non-finite values")
    log(f"scaffolds: {int(scaffs.n_scaffolds)}, multi-contig "
        f"{int((nm >= 2).sum())}, links {int(links.valid.sum())} valid, "
        f"gaps closed {closed} / open {n_gaps - closed}; scaffold N50 "
        f"{n50(slens)}, longest {int(slens.max())}, {int(slens.sum())} "
        f"bp; {share:.3f} of {n_pieces} pieces (the 200 longest "
        f"scaffolds split at N runs) are verbatim genome substrings")
    if share < MIN_QUALITY or out["stats"][-1].aligned_frac < MIN_QUALITY:
        raise AssertionError("streamed assembly quality collapsed")
    # what the peak is made of: one seed-index build over the dense
    # contig buffer, a transient that does not depend on the reads
    from repro_torch.core.alignment import build_seed_index
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_seed_index(out["contigs"], out["alive"], seed_len=21,
                     capacity=plan.seed_cap)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    log(f"one seed-index build over the "
        f"{list(out['contigs'].bases.shape)} contig buffer: peak "
        f"{extra / 1e9:.2f} GB above the {held / 1e9:.2f} GB held")

    # ---- where the time goes: one profiled run ----
    profile(lambda: Assembler(plan, Local()).assemble_stream(src),
            "assemble_stream")

    # ---- the inputs of each kernel's largest call (a warm run) ----
    with Recorder(ops, PATH3_KERNELS,
                  lambda name, a, kw: f"{name}_stream") as rec:
        t0 = time.perf_counter()
        Assembler(plan, Local()).assemble_stream(src)
        torch.cuda.synchronize()
        log(f"warm assemble_stream (recording inputs): "
            f"{time.perf_counter() - t0:.3f} s")
    rec.check_counts(launches)
    log(f"sw_extend calls' share of pairs with qlen = 0 (no candidate): "
        + ", ".join(f"{x:.4f}" for x in rec.no_candidate))
    records = [hold_against_plain(row, call, ops, launches[call[1]],
                                  "stream")
               for row, call in rec.calls.items()]
    del rec

    # ---- the same path with the plain versions on the card ----
    plain_plan = dataclasses.replace(plan, kernel_backend="torch")
    ops.reset_launches()
    p_out, _ = run_stream(Assembler, Local, plain_plan, src, ops, "plain")
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain run launched kernels: "
                             f"{ops.LAUNCHES}")
    assert_same_stream(out, p_out, "assemble_stream (kernels vs plain)")
    log("plain path: identical " + ", ".join(ASSEMBLE_KEYS)
        + ", stats, stream_stats")
    path3 = dict(plan=plan, src=src, n_batches=n_batches, peak=peak,
                 wall=sum(t for t, _ in clock.stages.values()),
                 alive=out["alive"].cpu(),
                 scaffold_seqs=type(seqs)(*(x.cpu() for x in seqs)),
                 stats=out["stats"], stream_stats=out["stream_stats"])
    del out, p_out

    # ---- streamed = in-memory: path 2's plan over the same reads ----
    t0 = time.perf_counter()
    st = Assembler(path2["plan"], Local()).assemble_stream(
        batches_from_readset(reads, STREAM_BATCH))
    torch.cuda.synchronize()
    assert_same(st["alive"], path2["alive"], "alive (streamed vs assemble)")
    assert_same(st["scaffold_seqs"], path2["scaffold_seqs"],
                "scaffold_seqs (streamed vs assemble)")
    c, c2 = st["contigs"], path2["contigs"]
    same_bases = torch.equal(c.bases.cpu(), c2.bases) and torch.equal(
        c.lengths.cpu(), c2.lengths)
    n_depths = int((c.depths.cpu() != c2.depths).sum())
    log(f"path 2's plan streamed in {STREAM_BATCH}-read batches "
        f"({time.perf_counter() - t0:.3f} s): scaffold_seqs and alive equal "
        f"to path 2's assemble; contig bases and lengths equal: "
        f"{same_bases}; contig depths that differ: {n_depths} (round-2 "
        f"counts of contig k-mers lack the read singletons the two-sighting "
        f"rule drops)")
    return records, path3


def assert_no_overflow(out, what):
    if not out["overflow"] or any(out["overflow"].values()):
        raise AssertionError(f"{what}: overflow {out['overflow']}")


def phase_mesh(api, ops, reads, comm, path2, path3, tmp):
    """Path 6: the Mesh context, 8 shards on the card, each shard's stage
    on its row block, the owner exchanges as transposes.  6a `assemble`
    with path 2's plan, 6b `assemble_stream` from path 3's FASTQ with
    path 3's plan, 6c the profile-HMM scorer over path 2's contigs and an
    `assemble` with its flags.  Returns the JSON records of its kernel
    rows (`<kernel>_mesh`, `<kernel>_mesh_stream`) and what path 7's Mesh
    server compares with."""
    Assembler, AssemblyPlan, Local = api
    from repro_torch.api import Mesh
    from repro_torch.dist.capacity import next_pow2

    S = MESH_SHARDS
    t_path = time.perf_counter()

    # ---- 6a: assemble ----
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.1,
                                     num_shards=S)
    if dataclasses.replace(path2["plan"], num_shards=S) != plan:
        raise AssertionError("path 6a's plan is not path 2's with 8 shards")
    log(f"path 6a plan: path 2's with num_shards={S}: pre_cap "
        f"{plan.pre_cap}, shard_table_cap {plan.shard_table_cap}, "
        f"route_cap {plan.route_cap}, localize_out_factor "
        f"{plan.localize_out_factor}; plan.bytes() (a shard) "
        f"{plan.bytes() / 1e9:.2f} GB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, clock = run_clocked(
        lambda hook: Assembler(plan, Mesh(S)).assemble(reads, hook=hook),
        StageClock(ops, "mer_walk", assemble_label), "mesh",
        "Mesh(8) assemble")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    wall = sum(t for t, _ in clock.stages.values())
    log(f"launches in Mesh(8) assemble: {launches}")
    check_path_kernels(launches, PATH2_KERNELS, "path 6a")
    log(f"peak device memory (Mesh(8) assemble): {peak / 1e9:.2f} GB; "
        f"path 2 (Local): {path2['peak'] / 1e9:.2f} GB; plan.bytes(): "
        f"{plan.bytes() / 1e9:.2f} GB a shard, {S * plan.bytes() / 1e9:.2f}"
        f" GB for {S} shards (not gated); wall {wall:.3f} s, path 2 "
        f"{path2['wall']:.3f} s; overflow {out['overflow']}")
    assert_no_overflow(out, "path 6a")
    for s, p in zip(out["stats"], path2["stats"]):
        log(f"[mesh] round k={s.k}: n_kmers={s.n_kmers} (path 2: "
            f"{p.n_kmers}), n_contigs={s.n_contigs} ({p.n_contigs}), "
            f"extended_bases={s.extended_bases} ({p.extended_bases}), "
            f"aligned_frac={s.aligned_frac:.4f} ({p.aligned_frac:.4f}), "
            f"route_overflow={s.route_overflow}")
    r1, p1 = out["stats"][0], path2["stats"][0]
    if (r1.n_kmers, r1.n_contigs) != (p1.n_kmers, p1.n_contigs):
        raise AssertionError("round 1 of Mesh(8) differs from path 2's: "
                             "gather_ksets is exact and round 1 has no "
                             "contig evidence")
    share, n_pieces = scaffold_piece_matches(out["scaffold_seqs"], comm)
    slens = out["scaffold_seqs"].lengths.cpu().numpy()
    slens = slens[slens > 0]
    log(f"Mesh(8) scaffolds: {int(out['scaffolds'].n_scaffolds)}, N50 "
        f"{n50(slens)}, {int(slens.sum())} bp; {share:.3f} of {n_pieces} "
        f"pieces verbatim (path 2: {path2['share']:.3f}; tolerance "
        f"{MESH_QUALITY_TOL})")
    if share < path2["share"] - MESH_QUALITY_TOL:
        raise AssertionError("Mesh(8) scaffold quality below path 2's")

    profile(lambda: Assembler(plan, Mesh(S)).assemble(reads),
            "Mesh(8) assemble")
    with Recorder(ops, PATH2_KERNELS, lambda n, a, kw: f"{n}_mesh") as rec:
        t0 = time.perf_counter()
        Assembler(plan, Mesh(S)).assemble(reads)
        torch.cuda.synchronize()
        log(f"warm Mesh(8) assemble (recording inputs): "
            f"{time.perf_counter() - t0:.3f} s")
    rec.check_counts(launches)
    records = [hold_against_plain(row, call, ops, launches[call[1]], "mesh",
                                  plain_reps=MESH_PLAIN_REPS)
               for row, call in rec.calls.items()]
    del rec

    plain_plan = dataclasses.replace(plan, kernel_backend="torch")
    ops.reset_launches()
    p_out, _ = run_clocked(
        lambda hook: Assembler(plain_plan, Mesh(S)).assemble(reads,
                                                             hook=hook),
        StageClock(ops, "mer_walk", assemble_label), "mesh plain",
        "Mesh(8) assemble, plain")
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain run launched kernels: {ops.LAUNCHES}")
    assert_same_assembly(out, p_out, "Mesh(8) assemble (kernels vs plain)")
    log("path 6a plain path: identical " + ", ".join(ASSEMBLE_KEYS)
        + ", stats")
    path6a = dict(plan=plan, peak=peak, wall=wall, launches=launches,
                  **host_result(out))
    del out, p_out
    log(f"path 6a: {time.perf_counter() - t_path:.1f} s")

    # ---- 6b: assemble_stream from path 3's FASTQ ----
    t_sub = time.perf_counter()
    # the reference's per-shard pre-combine size, kmer_capacity / S x 2,
    # is sized for a shard's share of the k-mer population, not for a
    # shard's block of a batch: at 32768 reads a batch, 262,144 rows
    # against ~370k distinct k-mers in a block of 4096 reads, so 140 of
    # the 160 pre-combines overflow on the card.  The block's
    # occurrence count bounds what it can hold.
    derived = dataclasses.replace(path3["plan"], num_shards=S)
    block = STREAM_BATCH // S * (reads.max_len - derived.k_min + 1)
    splan = dataclasses.replace(derived, pre_capacity=next_pow2(block))
    log(f"path 6b plan: path 3's with num_shards={S} and pre_capacity "
        f"{splan.pre_cap} (a shard's block of a batch: {block} "
        f"occurrences; the derived {derived.pre_cap} overflows): "
        f"bloom_slots {splan.bloom_slots} a shard, shard_table_cap "
        f"{splan.shard_table_cap}, route_cap {splan.route_cap}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # the rows' inputs are recorded in this run: a second streamed run
    # would cost as much again
    with Recorder(ops, PATH3_KERNELS,
                  lambda n, a, kw: f"{n}_mesh_stream") as rec:
        st, sclock = run_clocked(
            lambda hook: Assembler(splan, Mesh(S)).assemble_stream(
                path3["src"], hook=hook),
            StageClock(ops, "sw_extend", stream_label), "mesh stream",
            "Mesh(8) assemble_stream")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    swall = sum(t for t, _ in sclock.stages.values())
    log(f"launches in Mesh(8) assemble_stream: {launches}; peak "
        f"{peak / 1e9:.2f} GB; wall {swall:.3f} s (path 3: "
        f"{path3['wall']:.3f} s); overflow {st['overflow']}")
    check_path_kernels(launches, PATH3_KERNELS, "path 6b")
    want_sw = 3 * path3["n_batches"] * 2 * S
    if launches["sw_extend"] != want_sw:
        raise AssertionError(f"sw_extend launched {launches['sw_extend']} "
                             f"times, expected {want_sw}")
    rec.check_counts(launches)
    assert_same(st["alive"], path3["alive"],
                "alive (Mesh(8) streamed vs path 3)")
    assert_same(st["scaffold_seqs"], path3["scaffold_seqs"],
                "scaffold_seqs (Mesh(8) streamed vs path 3)")
    assert_no_overflow(st, "path 6b")
    log("path 6b: alive and scaffold_seqs equal to path 3's Local "
        "streamed run")
    for s in st["stats"]:
        sst = st["stream_stats"][s.k]
        log(f"[mesh stream] round k={s.k}: n_kmers={s.n_kmers}, n_contigs="
            f"{s.n_contigs}; {sst.occurrences_admitted}/"
            f"{sst.occurrences_total} occurrences admitted, route overflow "
            f"{sst.route_overflow}")
    path6b = dict(plan=splan, peak=peak, wall=swall, launches=launches,
                  **host_result(st))
    del st
    records += [hold_against_plain(row, call, ops, launches[call[1]],
                                   "mesh_stream",
                                   plain_reps=MESH_PLAIN_REPS)
                for row, call in rec.calls.items()]
    del rec
    log(f"path 6b: {time.perf_counter() - t_sub:.1f} s")

    # ---- 6d: Mesh(8) over an NCCL process group ----
    t_sub = time.perf_counter()
    phase_mesh_group(Assembler, ops, reads, path3["src"], path6a, path6b,
                     tmp)
    del path6b
    log(f"path 6d: {time.perf_counter() - t_sub:.1f} s")

    # ---- 6c: the profile-HMM scorer on path 2's contigs ----
    t_sub = time.perf_counter()
    from repro_torch.core import hmm
    g0 = comm.genomes[0]
    rng = np.random.default_rng(HMM_SEED)
    start = int(rng.integers(0, len(g0) - HMM_WINDOW))
    window = g0[start:start + HMM_WINDOW]
    contigs, alive = path2["contigs"], path2["alive"]
    lens = torch.where(alive, contigs.lengths, 0)
    prof = hmm.build_profile([window], device=HMM_DEVICE)
    cb, cl = contigs.bases.to(HMM_DEVICE), lens.to(HMM_DEVICE)
    hmm.hmm_hits(prof, cb[:1], cl[:1])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits, scores = hmm.hmm_hits(prof, cb, cl)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    n_hit = int(hits.sum())
    log(f"path 6c: hmm_hits over {int(alive.sum())} live contigs of path 2 "
        f"(profile: {HMM_WINDOW} bases of genome 0 at {start}): "
        f"{t_card:.3f} s on the card (synchronized), L = "
        f"{int(cl.max())} positions looped, {n_hit} flagged, best score "
        f"{float(scores.max()):.3f} (threshold {0.25 * HMM_WINDOW})")
    if n_hit < 1:
        raise AssertionError("the HMM flagged no contig")
    rnd = torch.from_numpy(rng.integers(0, 4, (1, 300)).astype(np.uint8))
    r_hit, r_score = hmm.hmm_hits(prof, rnd.to(HMM_DEVICE), torch.full(
        (1,), 300, dtype=torch.int32, device=HMM_DEVICE))
    log(f"path 6c: a seeded random 300-base row scores "
        f"{float(r_score[0]):.3f}, flagged {bool(r_hit[0])}")
    if bool(r_hit[0]):
        raise AssertionError("the HMM flagged a random sequence")
    t0 = time.perf_counter()
    c_hits, c_scores = hmm.hmm_hits(hmm.build_profile([window]),
                                    contigs.bases, lens)
    t_cpu = time.perf_counter() - t0
    d = float((scores.cpu() - c_scores).abs().max())
    log(f"path 6c: the CPU run ({t_cpu:.3f} s): flags equal "
        f"{torch.equal(hits.cpu(), c_hits)}, max |score difference| {d}")
    if not torch.equal(hits.cpu(), c_hits) or d > HMM_SCORE_TOL:
        raise AssertionError("HMM flags or scores differ between the card "
                             "and the CPU")
    ops.reset_launches()
    t0 = time.perf_counter()
    out_h = Assembler(path2["plan"], Local()).assemble(reads,
                                                       hmm_hit=hits)
    torch.cuda.synchronize()
    check_path_kernels(dict(ops.LAUNCHES), PATH2_KERNELS, "path 6c")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(
        out_h["scaffold_seqs"], path2["scaffold_seqs"]))
    log(f"path 6c: assemble(hmm_hit=...) on the kernels "
        f"{time.perf_counter() - t0:.3f} s: "
        f"{int(out_h['scaffolds'].n_scaffolds)} scaffolds, scaffold_seqs "
        f"{'equal to' if same else 'differ from'} path 2's")
    assert_no_overflow(out_h, "path 6c")
    del out_h
    log(f"path 6c: {time.perf_counter() - t_sub:.1f} s")
    log(f"path 6: {time.perf_counter() - t_path:.1f} s")
    return records, path6a


def host_result(out) -> dict:
    """What path 6d holds a group run to, on the host: contigs, alive,
    scaffold sequences, stats, overflow (and stream stats)."""
    keep = {key: type(out[key])(*(x.cpu() for x in out[key]))
            for key in ("contigs", "scaffold_seqs")}
    return dict(keep, alive=out["alive"].cpu(), stats=out["stats"],
                overflow=out["overflow"],
                stream_stats=out.get("stream_stats"))


def same_group_result(got, want, what):
    for key in ("contigs", "scaffold_seqs", "alive"):
        assert_same(tuple(got[key]) if key != "alive" else got[key],
                    tuple(want[key]) if key != "alive" else want[key],
                    f"{what}: {key}")
    for key in ("stats", "overflow", "stream_stats"):
        if got.get(key) != want.get(key):
            raise AssertionError(f"{what}: {key} differ: {got.get(key)} "
                                 f"against {want.get(key)}")


COLLECTIVES = ("all_to_all", "all_gather", "all_reduce")


def count_collectives(prof) -> dict:
    """{collective: [host calls, device kernels]} of the NCCL collectives
    in a profile: the process group's host ops (`c10d::alltoall_base_`,
    `nccl:all_to_all`, ...) and NCCL's kernels on the card."""
    from torch.autograd import DeviceType

    counts = {c: [0, 0] for c in COLLECTIVES}
    for e in prof.key_averages():
        key = e.key.lower()
        flat = key.replace("_", "")
        for c in COLLECTIVES:
            if c.replace("_", "") not in flat:
                continue
            if e.device_type == DeviceType.CUDA and "nccl" in key:
                counts[c][1] += e.count
            elif e.device_type == DeviceType.CPU and (
                    key.startswith("nccl:") or key.startswith("c10d::")):
                counts[c][0] += e.count
    return counts


def phase_mesh_group(Assembler, ops, reads, src, path6a, path6b, tmp):
    """Path 6d: `Mesh(8, group=g)` over an NCCL process group of one rank
    (`launch.mesh.make_data_mesh`, in this process), its 8 shards on the
    rank's card, the owner exchanges NCCL `all_to_all`s, the gathers and
    overflow sums NCCL `all_gather`s and `all_reduce`s: path 6a's
    `assemble` and path 6b's `assemble_stream` again, each equal to its
    6a or 6b run bit for bit (contigs, alive, scaffold sequences, every
    IterationStats field, the overflow dict, and the stream stats), each
    kernel launched as often as on 6a or 6b, and the collectives counted
    in a profiled `assemble`."""
    import torch.distributed as tdist

    from repro_torch.api import Mesh
    from repro_torch.launch import mesh as launch_mesh

    S = MESH_SHARDS
    # one rank on one host: NCCL's bootstrap stays on the loopback device
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    local_rank = os.environ.get("LOCAL_RANK")  # join_group sets it
    launch_mesh.join_group(0, 1, device="cuda",
                           init_file=os.path.join(tmp, "nccl_store"))
    try:
        mesh = launch_mesh.make_data_mesh(S)
        backend = tdist.get_backend(mesh.group)
        log(f"path 6d: make_data_mesh({S}): backend {backend}, world size "
            f"{mesh.world_size}, rank {mesh.rank} on {mesh.device} with "
            f"shards {list(mesh.shards)}")
        if (backend, mesh.world_size, str(mesh.device)) != (
                "nccl", 1, f"cuda:{torch.cuda.current_device()}"):
            raise AssertionError("path 6d's mesh is not one NCCL rank on "
                                 "its card")
        runs = (("assemble", path6a, PATH2_KERNELS, "mer_walk",
                 assemble_label,
                 lambda ctx, hook: Assembler(path6a["plan"], ctx).assemble(
                     reads, hook=hook)),
                ("assemble_stream", path6b, PATH3_KERNELS, "sw_extend",
                 stream_label,
                 lambda ctx, hook: Assembler(path6b["plan"], ctx)
                 .assemble_stream(src, hook=hook)))
        for what, want, kernels, kernel, label, run in runs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            out, clock = run_clocked(
                lambda hook: run(Mesh(S, group=mesh.group), hook),
                StageClock(ops, kernel, label), f"mesh group {what}",
                f"Mesh({S}, group) {what}")
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            wall = sum(t for t, _ in clock.stages.values())
            log(f"path 6d {what}: launches {launches}; wall {wall:.3f} s "
                f"(6{'a' if what == 'assemble' else 'b'}: "
                f"{want['wall']:.3f} s); peak {peak / 1e9:.2f} GB "
                f"({want['peak'] / 1e9:.2f} GB); overflow {out['overflow']}")
            check_path_kernels(launches, kernels, f"path 6d {what}")
            if launches != want["launches"]:
                raise AssertionError(
                    f"path 6d {what}: launches {launches} differ from the "
                    f"single-process run's {want['launches']}")
            same_group_result(host_result(out), want,
                              f"path 6d {what} (group vs one process)")
            log(f"path 6d {what}: contigs, alive, scaffold_seqs, stats, "
                f"overflow{', stream_stats' if want['stream_stats'] else ''}"
                f" equal to the single-process Mesh({S})")
            del out
        prof, _ = profile(
            lambda: Assembler(path6a["plan"], Mesh(S, group=mesh.group))
            .assemble(reads), f"Mesh({S}, group) assemble")
        counts = count_collectives(prof)
        del prof
        log("path 6d collectives in a profiled assemble (host calls, NCCL "
            "kernels on the card): " + "; ".join(
                f"{c} {h}, {d}" for c, (h, d) in counts.items()))
        missing = [c for c, (h, _) in counts.items() if h == 0]
        if missing:
            raise AssertionError(f"path 6d: no NCCL {missing} in the "
                                 f"profile")
    finally:
        tdist.destroy_process_group()
        if local_rank is None:
            os.environ.pop("LOCAL_RANK", None)
        else:
            os.environ["LOCAL_RANK"] = local_rank


def phase_small(api, mgsim, ExtensionPolicy):
    """Small inputs: both paths on the card equal the CPU runs.  Returns
    the assemble input's reads, plan and card result (path 7's small
    job)."""
    Assembler, AssemblyPlan, Local = api
    small_plan = AssemblyPlan(
        k_min=17, k_max=21, k_step=4, kmer_capacity=1 << 14, contig_cap=256,
        max_contig_len=2048, walk_capacity=1 << 15, link_capacity=1 << 10,
        max_scaffold_len=1 << 12, policy=ExtensionPolicy(err_rate=0.05))
    s_comm = mgsim.sample_community(41, num_genomes=2, genome_len=300,
                                    abundance_sigma=0.3)
    s_reads, _ = mgsim.generate_reads(42, s_comm, num_pairs=300,
                                      read_len=60, err_rate=0.003)
    rounds_plan = dataclasses.replace(small_plan, run_local_assembly=False)
    g = Assembler(rounds_plan, Local()).contig_rounds(s_reads)
    c = Assembler(rounds_plan, Local("cpu")).contig_rounds(s_reads)
    for x, y, what in zip(g[:3], c[:3], ("contigs", "alive", "alignments")):
        assert_same(x, y, f"small input {what} (card vs CPU)")
    if g[3] != c[3]:
        raise AssertionError("small input stats differ (card vs CPU)")
    log("small input, contig_rounds: card run equals the CPU run")
    a_comm = mgsim.sample_community(32, num_genomes=3, genome_len=500,
                                    abundance_sigma=0.3)
    a_reads, _ = mgsim.generate_reads(33, a_comm, num_pairs=600,
                                      read_len=60, err_rate=0.003)
    g = Assembler(small_plan, Local()).assemble(a_reads)
    c = Assembler(small_plan, Local("cpu")).assemble(a_reads)
    assert_same_assembly(g, c, "small input assemble (card vs CPU)")
    if not int(c["scaffold_seqs"].n_scaffolds):
        raise AssertionError("small input assemble made no scaffold")
    log("small input, assemble: card run equals the CPU run")
    return dict(reads=a_reads, plan=small_plan, result=g)


def phase_small_stream(api, reads):
    """Small inputs of path 3 on the card against the CPU: gapped
    `assemble_stream`, `assemble` with low_memory=True, and checkpoint
    resume (a second run over the same checkpoint_dir resumes every k and
    returns the same result).  Returns the streamed source, plan and card
    result (path 7's paused and killed jobs)."""
    Assembler, AssemblyPlan, Local = api
    from repro_torch.stream import batches_from_readset

    batches = batches_from_readset(reads, 256)
    plan = AssemblyPlan.from_stream(256, reads.max_len, (17, 21, 4),
                                    unique_kmers=2000, slack=4.0,
                                    gapped_align=True)
    g = Assembler(plan, Local()).assemble_stream(batches)
    c = Assembler(plan, Local("cpu")).assemble_stream(batches)
    assert_same_stream(g, c, "small input assemble_stream (card vs CPU)")
    if not int(c["scaffold_seqs"].n_scaffolds):
        raise AssertionError("small input assemble_stream made no scaffold")
    log("small input, gapped assemble_stream: card run equals the CPU run")
    lm = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.2,
                                   low_memory=True)
    assert_same_assembly(Assembler(lm, Local()).assemble(reads),
                         Assembler(lm, Local("cpu")).assemble(reads),
                         "small input low_memory assemble (card vs CPU)")
    log("small input, assemble(low_memory=True): card run equals the CPU "
        "run")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        a = Assembler(plan, Local()).assemble_stream(batches,
                                                     checkpoint_dir=tmp)
        b = Assembler(plan, Local()).assemble_stream(batches,
                                                     checkpoint_dir=tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if any(s.resumed for s in a["stream_stats"].values()) or not all(
            s.resumed for s in b["stream_stats"].values()):
        raise AssertionError("checkpoint: the second run did not resume "
                             "every k")
    assert_same_assembly(a, g, "checkpointed run vs plain run")
    assert_same_assembly(b, a, "resumed run vs checkpointed run")
    log("small input, checkpoint: the second run resumed every k and "
        "returned the same result")
    return dict(batches=batches, plan=plan, result=g)


def same_run(got, want, keys, what):
    """The keys of a job's result against a solo run's (on the host or
    the card), and the round stats."""
    for key in keys:
        assert_same(got[key], want[key], f"{what}: {key}")
    if got["stats"] != want["stats"]:
        raise AssertionError(f"{what}: stats differ")


def same_stream_stats(got, want, what):
    """StreamStats equal but for `resumed` (checkpoint bookkeeping)."""
    norm = lambda ss: {k: dataclasses.replace(v, resumed=False)
                       for k, v in ss.items()}
    if norm(got) != norm(want):
        raise AssertionError(f"{what}: stream_stats differ")


def finished(srv, what):
    """Every job of the server DONE: a job that failed (a kernel that did
    not build or launch, a wrong shape) fails the run with its error."""
    from repro_torch.serving import JobState
    bad = {j.name: (j.state.value, j.error) for j in srv.jobs.values()
           if j.state != JobState.DONE}
    if bad:
        raise AssertionError(f"{what}: jobs not DONE: {bad}")


def phase_serving(api, ops, reads, path2, path3, path6a, small, small_stream,
                  tmp):
    """Path 7: the assembly JobServer on the card.  One `JobServer(Local())`
    multiplexes path 2's in-memory job (high priority), path 3's streamed
    FASTQ job and the small input's job, with a budget that holds path 2's
    bill and the small job's but not path 3's beside them, so the small
    job backfills past the blocked streamed job; each result equals its
    solo run, each bill stands beside its measured peak.  Then a small
    streamed job paused and resumed, and one killed mid-run and recovered
    by a new server over the same journal, each equal to its solo run;
    and a `JobServer(Mesh(8))` whose job equals path 6a."""
    Assembler, AssemblyPlan, Local = api
    from repro_torch.api import Mesh
    from repro_torch.serving import JobServer, JobSpec, JobState, price

    t_path = time.perf_counter()
    # ---- the small job's solo peak (paths 2 and 3 measured theirs) ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Assembler(small["plan"], Local()).assemble(small["reads"])
    torch.cuda.synchronize()
    peaks = {"path2": path2["peak"], "path3": path3["peak"],
             "small": torch.cuda.max_memory_allocated()}

    specs = [JobSpec("path2", reads=reads, plan=path2["plan"], priority=2),
             JobSpec("path3", batches=path3["src"], plan=path3["plan"],
                     priority=1),
             JobSpec("small", reads=small["reads"], plan=small["plan"])]
    bills = {sp.name: price(sp).bytes() for sp in specs}
    budget = bills["path2"] + bills["small"]
    if not bills["small"] < bills["path3"] <= budget:
        raise AssertionError(f"bills {bills}: the streamed job must fit the "
                             f"budget alone but not beside path 2's job, "
                             f"where the small job fits")
    jdir = os.path.join(tmp, "journal")
    srv = JobServer(Local(), budget_bytes=budget, journal_dir=jdir)
    for sp in specs:
        srv.submit(sp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    finished(srv, "path 7")
    check_path_kernels(launches, PATH3_KERNELS, "path 7")
    with open(os.path.join(jdir, "journal.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    admitted = [r for r in recs if r["event"] == "admitted"]
    order = [r["name"] for r in admitted]
    most = max(budget - r["free"] for r in admitted)
    log(f"path 7 server: budget {budget / 1e9:.3f} GB (path 2's bill + the "
        f"small job's); admission order {order}; {len(recs)} journal "
        f"records; {wall:.3f} s for the three jobs (solo: path 2 "
        f"{path2['wall']:.3f} s, path 3 {path3['wall']:.3f} s); launches "
        f"{launches}")
    if order != ["path2", "small", "path3"]:
        raise AssertionError(f"admission order {order}: the small job did "
                             f"not backfill past the blocked streamed job")
    for name, job in srv.jobs.items():
        log(f"  job {name}: {job.events} events; bill (plan.bytes()) "
            f"{bills[name] / 1e9:.3f} GB, solo peak "
            f"{peaks[name] / 1e9:.3f} GB ({peaks[name] / bills[name]:.1f}x "
            f"the bill)")
    log(f"  multiplexed run: peak {peak / 1e9:.3f} GB against "
        f"{most / 1e9:.3f} GB billed at once (the admitted jobs' bills "
        f"summed) ({peak / most:.1f}x)")
    same_run(srv.result("path2"), path2, ("alive", "contigs",
                                          "scaffold_seqs"),
             "path 7 path2 job vs path 2's assemble")
    out3 = srv.result("path3")
    same_run(out3, path3, ("alive", "scaffold_seqs"),
             "path 7 path3 job vs path 3's assemble_stream")
    same_stream_stats(out3["stream_stats"], path3["stream_stats"],
                      "path 7 path3 job")
    assert_same_assembly(srv.result("small"), small["result"],
                         "path 7 small job vs its solo run")
    log("path 7 server: every job DONE; path2 equals path 2's assemble "
        "(alive, contigs, scaffold_seqs, stats), path3 path 3's "
        "assemble_stream (alive, scaffold_seqs, stats, stream_stats but "
        "resumed), small its solo run")
    del srv, out3

    # ---- pause and resume, kill and recover: a small streamed job ----
    sst = small_stream
    sbudget = 4 * price(JobSpec("s", batches=sst["batches"],
                                plan=sst["plan"])).bytes()
    srv = JobServer(Local(), budget_bytes=sbudget,
                    checkpoint_root=os.path.join(tmp, "ckpt_pause"))
    job = srv.submit(JobSpec("pause", batches=sst["batches"],
                             plan=sst["plan"]))
    ticks, paused = 0, False
    while srv.step():
        ticks += 1
        if ticks == 2:
            srv.pause("pause")
        if job.state == JobState.PAUSED:
            paused = True
            if srv.scheduler.reserved:
                raise AssertionError("a paused job holds its budget")
            srv.resume("pause")
    finished(srv, "path 7 pause")
    out = srv.result("pause")
    if not (paused and job.resumed and any(
            st.resumed for st in out["stream_stats"].values())):
        raise AssertionError("the paused job did not resume from its "
                             "checkpoint")
    assert_same_assembly(out, sst["result"], "paused and resumed job")
    same_stream_stats(out["stream_stats"], sst["result"]["stream_stats"],
                      "paused and resumed job")
    log(f"path 7 pause: paused after tick 2, resumed from its checkpoint, "
        f"{job.events} events; equal to its solo run")

    jdir, cdir = os.path.join(tmp, "journal_kill"), \
        os.path.join(tmp, "ckpt_kill")
    spec = lambda: JobSpec("crashy", batches=sst["batches"],
                           plan=sst["plan"])
    srv = JobServer(Local(), budget_bytes=sbudget, journal_dir=jdir,
                    checkpoint_root=cdir)
    job = srv.submit(spec())
    for _ in range(4):  # the server dies mid-run
        srv.step()
    if job.state != JobState.RUNNING:
        raise AssertionError(f"the job is {job.state.value} after 4 ticks")
    del srv, job
    gc.collect()
    srv = JobServer(Local(), budget_bytes=sbudget, journal_dir=jdir,
                    checkpoint_root=cdir)
    srv.recover([spec()])
    job = srv.jobs["crashy"]
    if not (job.state == JobState.QUEUED and job.resumed):
        raise AssertionError("recover did not re-queue the killed job")
    srv.run()
    finished(srv, "path 7 recover")
    out = srv.result("crashy")
    if not any(st.resumed for st in out["stream_stats"].values()):
        raise AssertionError("the recovered job did not fast-forward from "
                             "its checkpoint")
    assert_same_assembly(out, sst["result"], "killed and recovered job")
    same_stream_stats(out["stream_stats"], sst["result"]["stream_stats"],
                      "killed and recovered job")
    log(f"path 7 recover: killed after 4 ticks, recovered by a new server "
        f"over the same journal ({srv.journal_replay()}), equal to its "
        f"solo run")
    del srv, out

    # ---- a Mesh(8) server: path 6a's job ----
    mplan = path6a["plan"]
    srv = JobServer(Mesh(MESH_SHARDS), budget_bytes=mplan.bytes())
    srv.submit(JobSpec("mesh", reads=reads, plan=mplan))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    finished(srv, "path 7 Mesh(8)")
    check_path_kernels(dict(ops.LAUNCHES), PATH2_KERNELS, "path 7 Mesh(8)")
    same_run(srv.result("mesh"), path6a, ("alive", "scaffold_seqs"),
             "path 7 Mesh(8) job vs path 6a")
    log(f"path 7 Mesh(8) server: {time.perf_counter() - t0:.3f} s, bill "
        f"{mplan.bytes() / 1e9:.3f} GB a shard against path 6a's peak "
        f"{path6a['peak'] / 1e9:.3f} GB; equal to path 6a (alive, "
        f"scaffold_seqs, stats)")
    del srv
    log(f"path 7: {time.perf_counter() - t_path:.1f} s")


def flash_row(row, ops, q, k, v, launches, card, path="lm_prefill",
              causal=True):
    """flash_attention against its plain version at the path's call:
    within the tests' tolerance (|d| <= tol + tol |plain|), timed, with the
    SDPA call of the same shape and dtype as the library yardstick."""
    source, replaces = KERNELS["flash_attention"]
    tol = FLASH_TOL[q.dtype]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, backend="torch")
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    used = float((d / (tol + tol * want.float().abs())).max())
    if used > 1:
        raise AssertionError(f"{row}: kernel != plain version (max abs err "
                             f"{err}, tolerance {tol})")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = float((sdpa(q, k, v, is_causal=causal, enable_gqa=True).float()
                     - want.float()).abs().max())
    del got, want, d
    ms = median_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
    plain_ms = median_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                     backend="torch"))
    library_ms = median_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                        enable_gqa=True))
    B, H, S, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    fp32 = q.dtype == torch.float32
    rate = TENSOR_TF32X3_OPS_PER_S if fp32 else TENSOR_BF16_OPS_PER_S
    b_ms, b_by = bound_of(nbytes, flops, rate)
    simt_ms = bound_of(nbytes, flops, SCALAR_OPS_PER_S)[0]
    simt = f"; fp32 SIMT bound {simt_ms:.4f} ms" if fp32 else ""
    log(f"{row}: q {list(q.shape)}, k/v {list(k.shape)}, {q.dtype}, "
        f"{'causal' if causal else 'non-causal'}; "
        f"max abs err {err:.3g} against plain, {used:.3f} of the tolerance "
        f"|d| <= {tol} + {tol} |plain|; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
        f"(max abs err {lib_err:.3g} against plain); bound {b_ms:.4f} ms "
        f"({b_by}: {flops / 1e9:.1f} GFLOP at {rate / 1e12:.0f} TFLOP/s, "
        f"{nbytes / 1e6:.0f} MB){simt}; {card}")
    rec = dict(
        name=row, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        path=path, dtype=str(q.dtype).replace("torch.", ""), causal=causal)
    if fp32:
        rec["simt_bound_ms"] = simt_ms
    return rec


# tensor-core SASS each redesigned kernel must hold: (library, kernel name
# prefix, opcode)
TENSOR_CORE_SASS = (("flash_attention", "flash_bf16_kernel", "HGMMA"),
                    ("flash_attention", "flash_f32_kernel", "HMMA"),
                    ("ssd_scan", "ssd_scan_kernel", "HMMA"),
                    ("ssd_scan_wide", "ssd_wide_state_kernel", "HGMMA"),
                    ("ssd_scan_wide", "ssd_wide_output_kernel", "HGMMA"))


def tensor_core_report(build):
    """Registers and spills (-Xptxas -v) of every kernel, and the
    tensor-core instructions of the flash_attention and ssd_scan kernels
    in the built SASS (cuobjdump -sass): HGMMA (wgmma) in the bf16 flash
    kernel and the wide ssd_scan's two product kernels, HMMA (mma.sync)
    in the fp32 flash kernel and ssd_scan.  Fails if a kernel lacks its
    tensor-core instructions, or if one of the lookup, walk, chase or wide
    ssd_scan kernels spills or keeps a stack frame (sw_extend and
    seed_probe: spills only)."""
    def short(fn):  # the kernel's name and template arguments
        m = re.search(r"(\w+_kernel(<[^>]*>)?)\(", fn)
        return m.group(1) if m else fn

    ptxas = build.ptxas_report(build.last_build().get("log", ""))
    for fn, rep in ptxas.items():
        log(f"  ptxas {short(fn)}: {rep.get('registers')} registers, "
            f"{rep.get('stack_frame', 0)} bytes stack frame, "
            f"{rep.get('spill_stores', 0)} bytes spill stores, "
            f"{rep.get('spill_loads', 0)} bytes spill loads")
    # the alignment kernels keep a read's seeds and a DP row in registers;
    # the lookup, walk and chase kernels hold their probes in registers,
    # the wide ssd_scan's its wgmma accumulators and fragments.
    # Each must be in the report: a name is matched where no letter comes
    # before it, so a mangled one (`_ZN..13lookup_kernel..`) counts too.
    def named(kernel):
        return [fn for fn in ptxas
                if re.search(rf"(?<![A-Za-z_]){kernel}_kernel", fn)]

    checked = {k: named(k) for k in ("sw_extend", "seed_probe", "lookup",
                                     "mer_walk", "chase", "ssd_wide_state",
                                     "ssd_wide_carry", "ssd_wide_output")}
    missing = [k for k, fns in checked.items() if not fns]
    if missing:
        raise AssertionError(f"no ptxas report for the kernels {missing}")
    spilled = {short(fn): ptxas[fn] for k, fns in checked.items()
               for fn in fns
               if ptxas[fn].get("spill_stores") or ptxas[fn].get("spill_loads")
               or (k not in ("sw_extend", "seed_probe")
                   and ptxas[fn].get("stack_frame"))}
    if spilled:
        raise AssertionError(f"kernels spill or keep a stack frame: "
                             f"{spilled}")
    for lib in ("flash_attention", "ssd_scan", "ssd_scan_wide"):
        counts = build.sass_counts(lib)
        if counts is None:
            log(f"  cuobjdump -sass {lib}: not available")
            continue
        for fn, c in counts.items():
            log(f"  cuobjdump -sass {short(fn)}: {c['HGMMA']} HGMMA, "
                f"{c['HMMA']} HMMA")
        for want_lib, prefix, op in TENSOR_CORE_SASS:
            if want_lib != lib:
                continue
            fns = [fn for fn in counts if prefix in fn]
            if not fns or any(counts[fn][op] == 0 for fn in fns):
                raise AssertionError(f"{prefix}: no {op} in its SASS "
                                     f"({ {fn: counts[fn] for fn in fns} })")


def bound_of(nbytes, flops, rate) -> tuple:
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the
    card's memory rate and the operations over `rate`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def top2_gap(logits):
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def compare_logits(got, want, tol, what):
    """Max abs difference within tol, and the argmax equal at every
    position whose top-2 gap exceeds twice the difference."""
    # a row at a time: a [B, S, V] difference would be another logits
    diff = max(float((g - w).abs_().max()) for g, w in zip(got, want))
    same = got.argmax(-1) == want.argmax(-1)
    clear = top2_gap(want) > 2 * diff
    log(f"{what}: max abs logit difference {diff:.3g} (bound {tol}; logits "
        f"std {float(want.std()):.3f}); argmax agrees at "
        f"{int(same.sum())} of {same.numel()} positions, at every one of the "
        f"{int(clear.sum())} whose top-2 gap exceeds twice the difference: "
        f"{bool(same[clear].all())}")
    if diff > tol or not bool(same[clear].all()):
        raise AssertionError(f"{what}: the two disagree")
    return diff


def serve_and_check(cfg, model, ops, card, stages, weights, seed, path,
                    tol, routing=None, frames=None,
                    profile_steps=PROFILED_DECODE_STEPS):
    """The decode Engine serves SERVE_SLOTS seeded prompts of PROMPT_LENS
    tokens for SERVE_NEW_TOKENS greedy steps (steps/s, tokens/s, ms a step
    against the weight-read floor), launching no kernel; then a prefill of
    the same prompts through the kernel path against each slot's first
    decode logits (max abs difference <= tol; the argmax is the first
    emitted token wherever the top-2 gap exceeds twice the difference);
    then `profile_steps` decode steps under torch.profiler.  The engine
    must run every one of the steps.  An enc-dec model takes `frames` [SERVE_SLOTS, Sa, d]:
    the caller's part, `encode(frames)` written into the engine's
    `enc_out` before it runs (the engine takes no audio), and the frames
    beside the prompts in the prefill."""
    from repro_torch.models import encdec, registry
    from repro_torch.models.decode_engine import Engine, ServeConfig

    def hear(eng):
        if frames is not None:
            eng.state["enc_out"] = encdec.encode(cfg, model, frames)

    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=SERVE_SLOTS)
    lens[:2] = PROMPT_LENS  # both ends of the range
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
               for n in lens]
    eng = Engine(cfg, model, ServeConfig(max_len=SERVE_MAX_LEN,
                                         temperature=0.0),
                 batch_slots=SERVE_SLOTS, device=LM_DEVICE)
    hear(eng)
    for p in prompts:
        eng.submit(p)
    first = {}  # slot -> logits of the step that emitted its first token
    step = eng._step

    def recording_step(state, toks):
        out, state = step(state, toks)
        t = state["pos"] - 1
        for s, p in enumerate(prompts):
            if len(p) - 1 == t:
                first[s] = out[s, -1].clone()
        return out, state

    eng._step = recording_step
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with routing.record() if routing else contextlib.nullcontext():
        outs = eng.run(max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    stages["serve (Engine.run)"] = serve_s
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"decode launched kernels: {ops.LAUNCHES}")
    n_steps = eng.state["pos"]
    n_tok = sum(len(o) for o in outs)
    floor_ms = weights / HBM_BYTES_PER_S * 1e3
    log(f"serving: {SERVE_SLOTS} requests, prompts of {sorted(lens.tolist())}"
        f" tokens, greedy, max_len {SERVE_MAX_LEN}: {n_steps} decode steps "
        f"in {serve_s:.3f} s ({n_steps / serve_s:.2f} steps/s, "
        f"{1e3 * serve_s / n_steps:.3f} ms a step against the "
        f"{floor_ms:.3f} ms it takes to read the weights once), {n_tok} "
        f"tokens emitted ({n_tok / serve_s:.1f} tokens/s); {card}")
    ended = [len(o) == SERVE_NEW_TOKENS - len(p) + 1 or (o and o[-1] == 0)
             for o, p in zip(outs, prompts)]
    if (n_steps != SERVE_NEW_TOKENS or not all(ended)
            or len(first) != SERVE_SLOTS):
        raise AssertionError("the engine did not serve every request")

    # ---- prefill of the same prompts against the decode steps ----
    t0 = time.perf_counter()
    if routing is None:
        L = max(lens)
        padded = torch.zeros((SERVE_SLOTS, L), dtype=torch.int32,
                             device=LM_DEVICE)
        for s, p in enumerate(prompts):
            padded[s, :len(p)] = torch.tensor(p, dtype=torch.int32)
        batch = {"tokens": padded}
        if frames is not None:
            batch["frontend"] = frames
        pl, _ = registry.model_fns(cfg)["forward"](cfg, model, batch,
                                                   use_kernel=True)
        at = torch.tensor([len(p) - 1 for p in prompts], device=LM_DEVICE)
        pre = pl[torch.arange(SERVE_SLOTS, device=LM_DEVICE), at]
    else:
        pl, pre = None, prefill_replaying_decode(cfg, model, prompts, routing,
                                                 n_steps)
    torch.cuda.synchronize()
    stages["prefill of the 8 prompts (kernel path)"] = \
        time.perf_counter() - t0
    dec = torch.stack([first[s] for s in range(SERVE_SLOTS)])
    d = float((pre - dec).abs().max())
    tok0 = torch.tensor([o[0] for o in outs], device=LM_DEVICE)
    agree = pre.argmax(-1) == tok0
    clear = top2_gap(pre) > 2 * d
    log(f"prefill against decode at each prompt's last position: max abs "
        f"logit difference {d:.3g} (bound {tol}); prefill argmax = "
        f"first emitted token for {int(agree.sum())} of {SERVE_SLOTS} slots, "
        f"for every one of the {int(clear.sum())} whose top-2 gap exceeds "
        f"twice the difference: {bool(agree[clear].all())}")
    if d > tol or not bool(agree[clear].all()):
        raise AssertionError(f"{path}: prefill and decode disagree")
    del pl, pre, dec

    # ---- where decode's time goes: a short profiled run ----
    log(f"CUT: {profile_steps} profiled decode steps, not 32: the "
        f"profiler's processing of 32 took most of a path's wall")
    eng = Engine(cfg, model, ServeConfig(max_len=SERVE_MAX_LEN),
                 batch_slots=SERVE_SLOTS, device=LM_DEVICE)
    hear(eng)
    for p in prompts:
        eng.submit(p[:4])
    t0 = time.perf_counter()
    profile(lambda: eng.run(max_new_tokens=profile_steps),
            f"{profile_steps} decode steps")
    stages[f"{profile_steps} profiled decode steps (the profiler's "
           f"processing in)"] = time.perf_counter() - t0


class Routing:
    """The experts `ffn.top_k` picks, call by call (`record`, which also
    keeps each call's pairs dropped at capacity, `_bucket`'s overflow),
    and a replay of them (`replay`).  An MoE's top-k is discontinuous: two
    paths that differ by rounding (flash against plain attention, decode
    against prefill) pick another expert for a token whose k-th and
    (k+1)-th probabilities nearly tie, and then differ there by far more
    than the rounding.  So the path compared replays the picks of the
    path it is compared with, and `flips` counts the token-layers where
    its own picks would have been another set of experts."""

    def __init__(self):
        from repro_torch.models import ffn
        self.ffn = ffn
        self.top_k, self.bucket = ffn.top_k, ffn._bucket
        self.calls, self.drops, self.flips = [], [], 0

    @contextlib.contextmanager
    def _patched(self, top_k, bucket):
        self.ffn.top_k, self.ffn._bucket = top_k, bucket
        try:
            yield self
        finally:
            self.ffn.top_k, self.ffn._bucket = self.top_k, self.bucket

    def record(self):
        self.calls, self.drops = [], []

        def top_k(probs, k):
            vals, idx = self.top_k(probs, k)
            self.calls.append(idx)
            return vals, idx

        def bucket(*args):
            out = self.bucket(*args)
            self.drops.append(out[3])
            return out
        return self._patched(top_k, bucket)

    @contextlib.contextmanager
    def replay(self, calls):
        picks = iter(calls)

        def top_k(probs, k):
            idx = next(picks)
            own = self.top_k(probs, k)[1]
            self.flips += int((own.sort(-1).values != idx.sort(-1).values)
                              .any(-1).sum())
            return probs.gather(-1, idx), idx
        with self._patched(top_k, self.bucket):
            yield self
        if next(picks, None) is not None:
            raise AssertionError("the replay used fewer top-k calls than "
                                 "the recorded run made")


def prefill_replaying_decode(cfg, model, prompts, routing, n_steps):
    """Each slot's prompt alone through the kernel path's prefill, its
    experts the decode's picks at the same positions (decode step t fed
    position t of every slot, one top-k call a layer); returns the last
    position's logits of each slot.  Alone, a prompt of at most 128 tokens
    sends an expert at most 128 pairs, which the capacity floor of 128
    holds, so no pair is dropped, as in decode."""
    from repro_torch.models import transformer

    L = cfg.n_layers
    if len(routing.calls) != n_steps * L:
        raise AssertionError(f"{len(routing.calls)} top-k calls in "
                             f"{n_steps} decode steps of {L} layers")
    rows = []
    for s, p in enumerate(prompts):
        picks = [torch.stack([routing.calls[t * L + layer][s]
                              for t in range(len(p))])
                 for layer in range(L)]
        tok = torch.tensor([p], dtype=torch.int32, device=LM_DEVICE)
        with routing.replay(picks):
            logits, _ = transformer.forward(cfg, model, {"tokens": tok},
                                            use_kernel=True)
        rows.append(logits[0, -1])
    log(f"prefill of each prompt alone, replaying the decode's expert "
        f"picks: its own would differ at {routing.flips} of "
        f"{sum(map(len, prompts)) * L} token-layers")
    return torch.stack(rows)


def full_fp32():
    """fp32 products in full fp32: a kernel path is held against the plain
    path, and TF32 would keep ~3 digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def last_flash_call(ops):
    """Keeps the arguments of the last `ops.flash_attention` call made
    inside the block (the list it yields holds one (q, k, v, causal))."""
    calls = []
    orig = ops.flash_attention

    def record(q, k, v, **kw):
        calls[:] = [(q, k, v, kw.get("causal", True))]
        return orig(q, k, v, **kw)

    ops.flash_attention = record
    try:
        yield calls
    finally:
        ops.flash_attention = orig


def phase_lm(ops, card):
    """Path 4: llama3.2-3b at full width, random fp32 weights; the prefill
    forward through the flash kernel against the plain path, the kernel
    rows, and the decode Engine serving 8 requests, cross-checked against
    the prefill.  Returns the JSON records of the kernel's two rows."""
    from repro_torch.models import registry, transformer

    full_fp32()
    cfg = registry.get(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    stages = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=LM_DEVICE)
    gen.manual_seed(LM_SEED)
    model = transformer.init_params(cfg, gen, device=LM_DEVICE)
    torch.cuda.synchronize()
    stages["init_params"] = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    want_n = int(cfg.param_count()) + (2 * cfg.n_layers + 1) * cfg.d_model
    weights = torch.cuda.memory_allocated() - held0
    log(f"path 4 model: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied; {n} parameters "
        f"(param_count() + norms = {want_n}), {weights / 1e9:.2f} GB fp32 on "
        f"the card, random from torch.Generator seed {LM_SEED}, built in "
        f"{stages['init_params']:.2f} s")
    if n != want_n or next(model.parameters()).device.type != LM_DEVICE:
        raise AssertionError("the model is not llama3.2-3b at full width on "
                             "the card")

    # ---- prefill: the kernel path (clean), then the plain path ----
    log(f"CUT: prefill of B={PREFILL_B} x S={PREFILL_S} tokens instead of "
        f"prefill_32k's 32 x 32768: in fp32 that shape would take most of "
        f"the run's time limit")
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=LM_DEVICE, dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, aux = transformer.forward(cfg, model, {"tokens": tokens},
                                      use_kernel=True)
    torch.cuda.synchronize()
    stages["prefill (kernel path)"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"launches in the prefill forward: {launches}")
    check_path_kernels(launches, PATH4_KERNELS, "path 4")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected "
                             f"one a layer ({cfg.n_layers})")
    vpad = -(-cfg.vocab // 16) * 16
    if logits.shape != (PREFILL_B, PREFILL_S, vpad) or not bool(
            torch.isfinite(logits).all()) or float(aux) != 0.0:
        raise AssertionError("prefill logits have the wrong shape or are "
                             "not finite")
    ops.reset_launches()
    t0 = time.perf_counter()
    plain, _ = transformer.forward(cfg, model, {"tokens": tokens})
    torch.cuda.synchronize()
    stages["prefill (plain path)"] = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain path launched kernels: {ops.LAUNCHES}")
    compare_logits(logits, plain, LM_LOGIT_TOL,
                   "prefill, kernel path against plain path")
    del logits, plain

    # ---- where the time goes, and the path's call of the kernel ----
    with last_flash_call(ops) as calls:
        profile(lambda: transformer.forward(cfg, model, {"tokens": tokens},
                                            use_kernel=True),
                "prefill forward, kernel path")
    q, k, v, _ = calls[-1]  # the last layer's call
    records = [flash_row("flash_attention", ops, q, k, v,
                         launches["flash_attention"], card)]
    records.append(flash_row("flash_attention_bf16", ops, q.bfloat16(),
                             k.bfloat16(), v.bfloat16(),
                             launches["flash_attention"], card))
    del calls, q, k, v

    serve_and_check(cfg, model, ops, card, stages, weights, LM_SEED,
                    "path 4", LM_LOGIT_TOL)
    peak = torch.cuda.max_memory_allocated()
    for name, t in stages.items():
        log(f"[path 4] stage {name}: {t:.3f} s")
    log(f"peak device memory (path 4): {peak / 1e9:.2f} GB; {card}")
    del model
    torch.cuda.empty_cache()
    return records


def ssd_row(ops, x, a, b, c, launches, card, row="ssd_scan",
            path="hybrid_prefill", plain_reps=20):
    """ssd_scan against its plain version at the path's call: within
    |d| <= SSD_TOL + SSD_TOL |plain|, timed (the plain version a median
    of `plain_reps`); no single PyTorch call computes the scan, so there
    is no library yardstick.  Heads of P or N > 64 run the wide kernel,
    whose source the row names."""
    source, replaces = KERNELS["ssd_scan"]
    wide = x.shape[-1] > 64 or b.shape[-1] > 64
    if wide:
        source = SSD_WIDE_SOURCE
    got = ops.ssd_scan(x, a, b, c)
    want = ops.ssd_scan(x, a, b, c, backend="torch")
    d = (got - want).abs()
    err = float(d.max())
    used = float((d / (SSD_TOL + SSD_TOL * want.abs())).max())
    top = float(want.abs().max())
    if used > 1 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{row}: kernel != plain version (max abs "
                             f"err {err}, tolerance {SSD_TOL})")
    del got, want, d
    ms = median_ms(lambda: ops.ssd_scan(x, a, b, c))
    plain_ms = median_ms(lambda: ops.ssd_scan(x, a, b, c, backend="torch"),
                         reps=plain_reps)
    B, S, H, P = x.shape
    N = b.shape[-1]
    T = min(128, S)
    nc = S // T
    pairs = T * (T + 1) // 2  # causal (t, s) pairs of a chunk
    # C B^T and G x in every chunk; C . state and the state update in all
    # but one (the state is zero in the first chunk, and only y is output)
    flops = B * H * (nc * (2 * N + 2 * P) * pairs + (nc - 1) * 4 * T * P * N)
    nbytes = 4 * (2 * x.numel() + a.numel() + b.numel() + c.numel())
    b_ms, b_by = bound_of(nbytes, flops, TENSOR_TF32X3_OPS_PER_S)
    t_ops = flops / TENSOR_TF32X3_OPS_PER_S * 1e3
    simt_ms, simt_by = bound_of(nbytes, flops, SCALAR_OPS_PER_S)
    log(f"{row}: x {list(x.shape)}, a {list(a.shape)}, b/c "
        f"{list(b.shape)}, fp32, chunk {T}; max abs err {err:.3g} against "
        f"plain (|plain| <= {top:.1f}), {used:.3f} of the tolerance |d| <= "
        f"{SSD_TOL} + {SSD_TOL} |plain|; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.0f} MB; {flops / 1e9:.2f} GFLOP at "
        f"{TENSOR_TF32X3_OPS_PER_S / 1e12:.0f} TFLOP/s take {t_ops:.4f} ms); "
        f"fp32 SIMT bound {simt_ms:.4f} ms ({simt_by}); {card}")
    rec = dict(
        name=row, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        path=path, dtype="float32", simt_bound_ms=simt_ms)
    if wide:
        rec.update(ssd_wide_parts(x, a, b, c, row, nbytes, card))
    return rec


def ssd_wide_parts(x, a, b, c, row, nbytes, card) -> dict:
    """The wide ssd_scan's time by launch (state runs, run carry, output:
    CUDA events around each launch inside the library's call, the median
    of WIDE_LAUNCH_REPS calls after a warm-up; the profiler drops these
    launches' records late in a run) and the bytes its design moves: x, a,
    b, c and y once, the carried states [B, H, nc, P, N] written once by
    the state launch and read once by the output launch, and apart from
    those the run-start states the output launch rereads (an L2 hit for
    all but the first chunk of a run) and the carry's two passes over the
    run-start slots.  The byte floor is the bytes that must move (inputs,
    y, the states once each way) over the card's memory rate; the bound
    stays the operations bound of ssd_row."""
    import ctypes

    from repro_torch.kernels import build

    B, S, H, P = x.shape
    N = b.shape[-1]
    T = min(128, S)
    nc = S // T
    if P % 64 or N % 64 or any(t.data_ptr() % 16 for t in (x, b, c)):
        raise AssertionError(f"{row}: the timed launch takes whole 64-wide "
                             f"tiles and aligned data, got P={P}, N={N}")
    lib = build.library("ssd_scan_wide")
    R = lib.ssd_scan_wide_run_length(B, H, P, N, nc)
    slot = 4 * P * N  # one state, bytes
    states = B * H * (nc - 1) * slot  # written once, read once
    runs = -(-(nc - 1) // R) if nc > 1 else 0
    rereads = B * H * sum(1 for ch in range(1, nc)
                          if ch > R and ch % R) * slot
    carry = 2 * B * H * max(runs - 1, 0) * slot
    floor_bytes = nbytes + 2 * states
    floor_ms = floor_bytes / HBM_BYTES_PER_S * 1e3
    y = torch.empty_like(x)
    scratch = torch.empty((B, H, nc, P, N), dtype=torch.float32,
                          device=x.device)
    totals = torch.empty((B, H, nc), dtype=torch.float32, device=x.device)
    ms = (ctypes.c_float * 3)()
    names = ("ssd_wide_state_kernel", "ssd_wide_carry_kernel",
             "ssd_wide_output_kernel")
    times = []
    for _ in range(WIDE_LAUNCH_REPS + 1):
        err = lib.ssd_scan_wide_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), totals.data_ptr(), B, S, H, P,
            N, T, torch.cuda.current_stream().cuda_stream, ms)
        if err:
            raise RuntimeError(f"{row}: timed launch failed: "
                               f"{lib.repro_error_string(err).decode()}")
        times.append(list(ms))
    launch_ms = {k: float(np.median([t[i] for t in times[1:]]))
                 for i, k in enumerate(names)}
    del y, scratch, totals
    log(f"{row} by launch (device ms, CUDA events, median of "
        f"{WIDE_LAUNCH_REPS} calls): " + "; ".join(
            f"{k} {v:.4f}" for k, v in launch_ms.items())
        + f"; sum {sum(launch_ms.values()):.4f}")
    log(f"{row} bytes of the design: inputs and y {nbytes / 1e6:.1f} MB, "
        f"carried states {states / 1e6:.1f} MB written + "
        f"{states / 1e6:.1f} MB read (run length R {R}, {runs} runs), "
        f"run-start rereads {rereads / 1e6:.1f} MB, carry "
        f"{carry / 1e6:.1f} MB; byte floor {floor_bytes / 1e6:.1f} MB, "
        f"{floor_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {card}")
    return dict(launch_ms=launch_ms, run_length=R,
                state_bytes=2 * states, byte_floor_ms=floor_ms)


def phase_hybrid(ops, card):
    """Path 5: zamba2-7b at full width, random fp32 weights; the prefill
    forward through ssd_scan and flash_attention (D = 112) against the
    plain path, the kernel rows, the decode Engine serving 8 requests
    cross-checked against the prefill, and a float64 witness on the first
    WITNESS_GROUPS groups.  Returns the JSON records of its three rows."""
    from repro_torch.models import registry, transformer

    full_fp32()
    cfg = registry.get(HYBRID_ARCH)
    n_groups, rem = divmod(cfg.n_layers, cfg.attn_every)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    stages = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=LM_DEVICE)
    gen.manual_seed(HYBRID_SEED)
    model = transformer.init_params(cfg, gen, device=LM_DEVICE)
    torch.cuda.synchronize()
    stages["init_params"] = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    weights = torch.cuda.memory_allocated() - held0
    log(f"path 5 model: {cfg.name}, {cfg.n_layers} Mamba-2 layers in "
        f"{n_groups} groups of {cfg.attn_every} and a tail of {rem}, "
        f"d_model {cfg.d_model}, {2 * cfg.d_model // cfg.ssm_head_dim} SSM "
        f"heads of P = {cfg.ssm_head_dim}, N = {cfg.ssm_state}; one shared "
        f"block ({cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}) after "
        f"every group; vocab {cfg.vocab}, untied; {n} parameters (the "
        f"reference's init_params leaves: {HYBRID_PARAMS}; its "
        f"param_count(): {int(cfg.param_count())}), {weights / 1e9:.2f} GB "
        f"fp32 on the card, random from torch.Generator seed {HYBRID_SEED}, "
        f"built in {stages['init_params']:.2f} s")
    if n != HYBRID_PARAMS or next(model.parameters()).device.type != \
            LM_DEVICE:
        raise AssertionError("the model is not zamba2-7b at full width on "
                             "the card")

    # ---- prefill: the kernel path (clean), then the plain path ----
    log(f"CUT: prefill of B={PREFILL_B} x S={PREFILL_S} tokens "
        f"({PREFILL_S // 128} chunks of 128) instead of prefill_32k's "
        f"32 x 32768: in fp32 that shape would take most of the run's time "
        f"limit")
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=LM_DEVICE, dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, aux = transformer.forward(cfg, model, {"tokens": tokens},
                                      use_kernel=True)
    torch.cuda.synchronize()
    stages["prefill (kernel path)"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"launches in the prefill forward: {launches}")
    check_path_kernels(launches, PATH5_KERNELS, "path 5")
    if launches["ssd_scan"] != cfg.n_layers or \
            launches["flash_attention"] != n_groups:
        raise AssertionError(f"launches {launches}: expected ssd_scan once "
                             f"a Mamba-2 layer ({cfg.n_layers}) and "
                             f"flash_attention once a group ({n_groups})")
    if logits.shape != (PREFILL_B, PREFILL_S, cfg.vocab) or not bool(
            torch.isfinite(logits).all()) or float(aux) != 0.0:
        raise AssertionError("prefill logits have the wrong shape or are "
                             "not finite")
    ops.reset_launches()
    t0 = time.perf_counter()
    plain, _ = transformer.forward(cfg, model, {"tokens": tokens})
    torch.cuda.synchronize()
    stages["prefill (plain path)"] = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain path launched kernels: {ops.LAUNCHES}")
    compare_logits(logits, plain, HYBRID_LOGIT_TOL,
                   "prefill, kernel path against plain path")
    del logits, plain

    # ---- where the time goes, and the path's calls of the kernels ----
    calls = {}
    orig = {name: getattr(ops, name) for name in PATH5_KERNELS}

    def recorder(name):
        def call(*args, **kw):
            calls[name] = args
            return orig[name](*args, **kw)
        return call

    for name in PATH5_KERNELS:
        setattr(ops, name, recorder(name))
    try:
        profile(lambda: transformer.forward(cfg, model, {"tokens": tokens},
                                            use_kernel=True),
                "prefill forward, kernel path")
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)
    records = [ssd_row(ops, *calls["ssd_scan"], launches["ssd_scan"], card)]
    q, k, v = calls["flash_attention"]  # the last group's call
    records.append(flash_row("flash_attention_d112", ops, q, k, v,
                             launches["flash_attention"], card,
                             "hybrid_prefill"))
    records.append(flash_row("flash_attention_d112_bf16", ops, q.bfloat16(),
                             k.bfloat16(), v.bfloat16(),
                             launches["flash_attention"], card,
                             "hybrid_prefill"))
    del calls, q, k, v

    # ---- serving, prefill against decode, a profiled decode ----
    serve_and_check(cfg, model, ops, card, stages, weights, HYBRID_SEED,
                    "path 5", HYBRID_LOGIT_TOL)
    peak = torch.cuda.max_memory_allocated()

    # ---- the float64 witness on the first WITNESS_GROUPS groups ----
    t0 = time.perf_counter()
    cut_cfg = dataclasses.replace(cfg, n_layers=WITNESS_GROUPS *
                                  cfg.attn_every)
    cut = transformer.HybridLM(
        cut_cfg, model.embed.data, model.ln_f.data,
        [list(g) for g in model.mamba[:WITNESS_GROUPS]], [], model.shared,
        model.lm_head.data)
    batch = {"tokens": tokens}
    kern, _ = transformer.forward(cut_cfg, cut, batch, use_kernel=True)
    plain, _ = transformer.forward(cut_cfg, cut, batch)
    del model  # the cut shares its layers; the rest of the model is freed
    gc.collect()  # and nothing in a reference cycle still holds it
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cut.to(torch.float64)
    exact, _ = transformer.forward(cut_cfg, cut, batch)
    torch.cuda.synchronize()
    stages["float64 witness (cut stack, 3 forwards)"] = \
        time.perf_counter() - t0
    k_err = float((kern.double() - exact).abs().max())
    p_err = float((plain.double() - exact).abs().max())
    kp = float((kern - plain).abs().max())
    log(f"float64 witness, the first {cut_cfg.n_layers} Mamba-2 layers and "
        f"{WITNESS_GROUPS} shared blocks on the prefill's tokens (logits "
        f"std {float(exact.std()):.3f}): kernel path against plain path "
        f"{kp:.3g}; against the plain path in float64: kernel path "
        f"{k_err:.3g}, plain path {p_err:.3g} (bound on the kernel path: "
        f"2 x {p_err:.3g})")
    if not k_err <= 2 * p_err:
        raise AssertionError("the kernel path strays further from float64 "
                             "than twice the plain path's rounding")
    for name, t in stages.items():
        log(f"[path 5] stage {name}: {t:.3f} s")
    log(f"peak device memory (path 5, before the witness): {peak / 1e9:.2f} "
        f"GB; {card}")
    del cut, kern, plain, exact, tokens
    torch.cuda.empty_cache()
    return records


def phase_moe(ops, card):
    """Path 8: qwen2-moe-a2.7b at full width, random fp32 weights; the
    prefill forward through the flash kernel (D = 128) against the plain
    path, the MoE dispatch's drops at capacity a layer, the kernel rows,
    and the decode Engine serving 8 requests, cross-checked against a
    prefill of each prompt.  The compared paths replay the expert picks of
    the path they are compared with (`Routing`).  Returns the JSON records
    of the kernel's two rows."""
    from repro_torch.models import ffn, registry, transformer

    full_fp32()
    cfg = registry.get(MOE_ARCH)
    E, L = cfg.n_experts + cfg.expert_pad, cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    stages = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=LM_DEVICE)
    gen.manual_seed(MOE_SEED)
    model = transformer.init_params(cfg, gen, device=LM_DEVICE)
    torch.cuda.synchronize()
    stages["init_params"] = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    weights = torch.cuda.memory_allocated() - held0
    experts = L * E * 3 * cfg.d_model * cfg.moe_d_ff
    log(f"path 8 model: {cfg.name}, {L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of {cfg.hd}; "
        f"{cfg.n_experts} routed experts (+{cfg.expert_pad} padded: E = {E})"
        f" of d_ff {cfg.moe_d_ff}, top-{cfg.top_k}, {cfg.n_shared_experts} "
        f"shared; vocab {cfg.vocab}, untied; {n} parameters (the "
        f"reference's init_params leaves: {MOE_PARAMS}; its param_count(): "
        f"{int(cfg.param_count())}), {experts} of them in the expert "
        f"stacks; {weights / 1e9:.2f} GB fp32 on the card, random from "
        f"torch.Generator seed {MOE_SEED}, built in "
        f"{stages['init_params']:.2f} s")
    if n != MOE_PARAMS or next(model.parameters()).device.type != \
            LM_DEVICE:
        raise AssertionError("the model is not qwen2-moe-a2.7b at full "
                             "width on the card")

    # ---- prefill: the kernel path (clean), then the plain path ----
    B, S = PREFILL_B, PREFILL_S
    T = B * S
    C = ffn.capacity(T, cfg)
    log(f"CUT: prefill of B={B} x S={S} tokens instead of prefill_32k's 32 "
        f"x 32768: in fp32 that shape would take most of the run's time "
        f"limit; capacity C = {C} rows an expert for {T * cfg.top_k} "
        f"(token, expert) pairs")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=LM_DEVICE, dtype=torch.int32)
    routing = Routing()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with routing.record():
        logits, aux = transformer.forward(cfg, model, {"tokens": tokens},
                                          use_kernel=True)
    torch.cuda.synchronize()
    stages["prefill (kernel path)"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"launches in the prefill forward: {launches}")
    check_path_kernels(launches, PATH8_KERNELS, "path 8")
    if launches["flash_attention"] != L:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected "
                             f"one a layer ({L})")
    if logits.shape != (B, S, cfg.vocab) or not bool(
            torch.isfinite(logits).all()) or not 0 < float(aux) < 1e3:
        raise AssertionError("prefill logits have the wrong shape or are "
                             "not finite, or the aux loss is off")
    drops = [int(d) for d in routing.drops]
    log(f"(token, expert) pairs dropped at capacity (C = {C}, _bucket's "
        f"overflow) in layers 0-{L - 1}: {drops}, {sum(drops)} of "
        f"{L * T * cfg.top_k} in all; aux loss {float(aux):.6f}")
    if len(drops) != L:
        raise AssertionError("the dispatch did not run once a layer")
    ops.reset_launches()
    t0 = time.perf_counter()
    with routing.replay(routing.calls):
        plain, p_aux = transformer.forward(cfg, model, {"tokens": tokens})
    torch.cuda.synchronize()
    stages["prefill (plain path)"] = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain path launched kernels: {ops.LAUNCHES}")
    log(f"the plain path replays the kernel path's expert picks; its own "
        f"would differ at {routing.flips} of {T * L} token-layers")
    compare_logits(logits, plain, MOE_LOGIT_TOL,
                   "prefill, kernel path against plain path")
    d_aux = abs(float(aux) - float(p_aux))
    log(f"aux loss, kernel path against plain path: {d_aux:.3g} (bound "
        f"{MOE_LOGIT_TOL})")
    if d_aux > MOE_LOGIT_TOL:
        raise AssertionError("the aux losses of the two paths disagree")
    del logits, plain

    # ---- where the time goes, and the path's call of the kernel ----
    with last_flash_call(ops) as calls:
        profile(lambda: transformer.forward(cfg, model, {"tokens": tokens},
                                            use_kernel=True),
                "prefill forward, kernel path")
    q, k, v, _ = calls[-1]  # the last layer's call
    records = [flash_row("flash_attention_moe", ops, q, k, v,
                         launches["flash_attention"], card, "moe_prefill")]
    records.append(flash_row("flash_attention_moe_bf16", ops, q.bfloat16(),
                             k.bfloat16(), v.bfloat16(),
                             launches["flash_attention"], card,
                             "moe_prefill"))
    del calls, q, k, v, tokens

    # ---- serving: every expert runs C = 128 rows a step ----
    dense = n - experts
    flops = 2 * (ffn.capacity(SERVE_SLOTS, cfg) * experts
                 + SERVE_SLOTS * dense)
    log(f"decode at {SERVE_SLOTS} slots: each expert product runs C = "
        f"{ffn.capacity(SERVE_SLOTS, cfg)} rows, so a step reads all "
        f"{weights / 1e9:.2f} GB ({weights / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"at 3.35 TB/s) and does {flops / 1e12:.3f} TFLOP of fp32 products "
        f"({flops / SCALAR_OPS_PER_S * 1e3:.3f} ms at 67 TFLOP/s)")
    serve_and_check(cfg, model, ops, card, stages, weights, MOE_SEED,
                    "path 8", MOE_LOGIT_TOL, routing=Routing())
    peak = torch.cuda.max_memory_allocated()
    for name, t in stages.items():
        log(f"[path 8] stage {name}: {t:.3f} s")
    log(f"peak device memory (path 8): {peak / 1e9:.2f} GB; {card}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return records


def slstm_launch_share(prof, wall):
    """The sLSTM loop's share of a profiled run's wall and of its kernel
    launches: the spans of `record_function("slstm_block")` against the
    runtime's launch calls (cudaLaunchKernel and its kin) in them."""
    from torch.autograd import DeviceType

    spans, starts = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == "slstm_block":
            spans.append((e.time_range.start, e.time_range.end))
        elif "LaunchKernel" in e.name:
            starts.append(e.time_range.start)
    inside = sum(any(lo <= t <= hi for lo, hi in spans) for t in starts)
    span_s = sum(hi - lo for lo, hi in spans) / 1e6
    return span_s / wall, inside, len(starts)


def phase_xlstm(ops, card):
    """Path 9: xlstm-125m at full width, random fp32 weights; the prefill
    forward through the wide ssd_scan against the plain path (with a
    float64 witness of the whole model), the sLSTM loop's share of the
    prefill, the kernel's rows at the prefill's call and at long_500k's
    length, and the decode Engine serving 8 requests, cross-checked
    against the prefill.  Returns the JSON records of its two rows."""
    from repro_torch.models import registry, ssm, transformer

    full_fp32()
    cfg = registry.get(XLSTM_ARCH)
    n_pairs = cfg.n_layers // 2
    hd = cfg.d_model // cfg.n_heads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    stages = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=LM_DEVICE)
    gen.manual_seed(XLSTM_SEED)
    model = transformer.init_params(cfg, gen, device=LM_DEVICE)
    torch.cuda.synchronize()
    stages["init_params"] = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    weights = torch.cuda.memory_allocated() - held0
    log(f"path 9 model: {cfg.name}, {n_pairs} pairs of an mLSTM block "
        f"({cfg.n_heads} heads of P = N = {hd}) and an sLSTM block, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, untied; {n} parameters (the "
        f"reference's init_params leaves: {XLSTM_PARAMS}; its "
        f"param_count(): {int(cfg.param_count())}), {weights / 1e9:.2f} GB "
        f"fp32 on the card, random from torch.Generator seed {XLSTM_SEED}, "
        f"built in {stages['init_params']:.2f} s")
    if n != XLSTM_PARAMS or next(model.parameters()).device.type != \
            LM_DEVICE:
        raise AssertionError("the model is not xlstm-125m at full width on "
                             "the card")

    # ---- prefill: the kernel path (clean), the plain path, float64 ----
    log(f"CUT: prefill of B={PREFILL_B} x S={PREFILL_S} tokens "
        f"({PREFILL_S // 128} chunks of 128) instead of prefill_32k's "
        f"32 x 32768, as paths 4, 5 and 8; long_500k is not run end to "
        f"end, only its scan call (below)")
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=LM_DEVICE, dtype=torch.int32)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, aux = transformer.forward(cfg, model, batch, use_kernel=True)
    torch.cuda.synchronize()
    stages["prefill (kernel path)"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"launches in the prefill forward: {launches}")
    check_path_kernels(launches, PATH9_KERNELS, "path 9")
    if launches["ssd_scan"] != n_pairs:
        raise AssertionError(f"ssd_scan launched {launches['ssd_scan']} "
                             f"times, expected one an mLSTM block "
                             f"({n_pairs})")
    if logits.shape != (PREFILL_B, PREFILL_S, cfg.vocab) or not bool(
            torch.isfinite(logits).all()) or float(aux) != 0.0:
        raise AssertionError("prefill logits have the wrong shape or are "
                             "not finite")
    ops.reset_launches()
    t0 = time.perf_counter()
    plain, _ = transformer.forward(cfg, model, batch)
    torch.cuda.synchronize()
    stages["prefill (plain path)"] = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain path launched kernels: {ops.LAUNCHES}")
    t0 = time.perf_counter()
    exact_model = copy.deepcopy(model).to(torch.float64)
    exact, _ = transformer.forward(cfg, exact_model, batch)
    del exact_model
    torch.cuda.synchronize()
    stages["float64 witness (plain path)"] = time.perf_counter() - t0
    k_err = max(float((k.double() - e).abs_().max())
                for k, e in zip(logits, exact))
    p_err = max(float((p.double() - e).abs_().max())
                for p, e in zip(plain, exact))
    del exact
    tol = XLSTM_LOGIT_TOL if p_err <= XLSTM_LOGIT_TOL else float("inf")
    log(f"float64 witness, the whole model on the prefill's tokens: kernel "
        f"path {k_err:.3g}, plain path {p_err:.3g} from it; the kernel path "
        f"is held to the plain path within {XLSTM_LOGIT_TOL}"
        + ("" if tol < float("inf") else
           f", and, the plain path being further off, to within 2 x "
           f"{p_err:.3g} of float64"))
    compare_logits(logits, plain, tol,
                   "prefill, kernel path against plain path")
    if tol == float("inf") and not k_err <= 2 * p_err:
        raise AssertionError("the kernel path strays further from float64 "
                             "than twice the plain path's rounding")
    del logits, plain

    # ---- the sLSTM loop's share; the path's last call of the scan ----
    calls = {}
    spent = [0.0]
    orig_scan, orig_slstm = ops.ssd_scan, ssm.slstm_block

    def scan(*args, **kw):
        calls["ssd_scan"] = args
        return orig_scan(*args, **kw)

    def slstm(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.profiler.record_function("slstm_block"):
            out = orig_slstm(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    ops.ssd_scan, ssm.slstm_block = scan, slstm
    try:
        t0 = time.perf_counter()
        transformer.forward(cfg, model, batch, use_kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"prefill with each sLSTM block timed (host clock, synchronized "
            f"before and after): {wall:.3f} s, the {n_pairs} sLSTM loops "
            f"{spent[0]:.3f} s ({100 * spent[0] / wall:.1f}%), the rest "
            f"{wall - spent[0]:.3f} s; {card}")
        last = calls["ssd_scan"]  # the full prefill's last call
        log(f"CUT: the profiled prefill takes B={PREFILL_B} x "
            f"S={XLSTM_PROFILE_S} tokens: the sLSTM loop launches ~11 "
            f"kernels a position and layer, and the profiler's events of "
            f"2 x {PREFILL_S} would take longer to gather than the run")
        short = {"tokens": tokens[:, :XLSTM_PROFILE_S].contiguous()}
        prof, pwall = profile(
            lambda: transformer.forward(cfg, model, short, use_kernel=True),
            f"prefill forward of {PREFILL_B} x {XLSTM_PROFILE_S}, kernel "
            f"path")
    finally:
        ops.ssd_scan, ssm.slstm_block = orig_scan, orig_slstm
    share, inside, total = slstm_launch_share(prof, pwall)
    log(f"  the sLSTM loops in that run: {100 * share:.1f}% of the wall, "
        f"{inside} of its {total} kernel launches "
        f"({100 * inside / max(total, 1):.1f}%)")
    del prof
    records = [ssd_row(ops, *last, launches["ssd_scan"], card,
                       row="ssd_scan_xlstm", path="xlstm_prefill")]
    del calls, last

    # ---- the wide scan alone at long_500k's length ----
    t0 = time.perf_counter()
    H = cfg.n_heads
    g = torch.Generator(device=LM_DEVICE)
    g.manual_seed(XLSTM_SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=LM_DEVICE)

    # the mLSTM's inputs at init: x = v sigmoid(i), a = log sigmoid(f),
    # b = k, c = q / sqrt(P)
    x = randn(LONG_B, LONG_S, H, hd) * torch.sigmoid(
        randn(LONG_B, LONG_S, H))[..., None]
    a = torch.nn.functional.logsigmoid(randn(LONG_B, LONG_S, H))
    b = randn(LONG_B, LONG_S, H, hd)
    c = randn(LONG_B, LONG_S, H, hd) / hd ** 0.5
    log(f"long_500k's scan call: B={LONG_B}, S={LONG_S}, H={H}, P = N = "
        f"{hd}, {x.numel() * 4 / 1e9:.2f} GB a tensor; the plain version "
        f"timed {LONG_PLAIN_REPS} times")
    records.append(ssd_row(ops, x, a, b, c, launches["ssd_scan"], card,
                           row="ssd_scan_xlstm_long", path="xlstm_long",
                           plain_reps=LONG_PLAIN_REPS))
    del x, a, b, c
    torch.cuda.synchronize()
    stages["long_500k scan call (kernel and plain)"] = \
        time.perf_counter() - t0
    peak_long = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    serve_and_check(cfg, model, ops, card, stages, weights, XLSTM_SEED,
                    "path 9", XLSTM_LOGIT_TOL)
    for name, t in stages.items():
        log(f"[path 9] stage {name}: {t:.3f} s")
    peak = torch.cuda.max_memory_allocated()
    log(f"peak device memory (path 9): {peak_long / 1e9:.2f} GB through "
        f"the long_500k scan call, {peak / 1e9:.2f} GB in all; {card}")
    del model, tokens, batch
    gc.collect()
    torch.cuda.empty_cache()
    return records


def phase_whisper(ops, card):
    """Path 10: whisper-large-v3 at full width, random fp32 weights: the
    prefill forward (the decoder's causal self-attention through the flash
    kernel) against the plain path; the encoder once more under
    ATTN_IMPL="flash" (its non-causal attention through the kernel)
    against the naive encoder; decode, with the encoder's output written
    into the fp32 state, against the teacher-forced forward; the kernel
    rows at the decoder's and the encoder's calls; and the decode Engine
    serving 8 requests after the caller writes `encode`'s output into its
    state.  Returns the JSON records of the kernel's four rows."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import encdec, flags, registry

    full_fp32()
    cfg = registry.get(WHISPER_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    stages = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=LM_DEVICE)
    gen.manual_seed(WHISPER_SEED)
    model = encdec.init_params(cfg, gen, device=LM_DEVICE)
    torch.cuda.synchronize()
    stages["init_params"] = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    weights = torch.cuda.memory_allocated() - held0
    # a decode step reads the decoder's layers and the head (one row of
    # the embedding and of pos_dec, and none of the encoder)
    step_bytes = 4 * (sum(p.numel() for p in model.dec.parameters())
                      + model.lm_head.numel() + model.ln_f.numel())
    log(f"path 10 model: {cfg.name}, {cfg.n_enc_layers} encoder and "
        f"{cfg.n_layers} decoder layers (a cross-attention each), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff} "
        f"({cfg.act}), vocab {cfg.vocab}, learned positions ({cfg.max_seq} "
        f"decoder, {cfg.enc_max_seq} encoder); {n} parameters (the "
        f"reference's init_params leaves: {WHISPER_PARAMS}; its "
        f"param_count(): {int(cfg.param_count())}), {weights / 1e9:.2f} GB "
        f"fp32 on the card, random from torch.Generator seed "
        f"{WHISPER_SEED}, built in {stages['init_params']:.2f} s")
    if n != WHISPER_PARAMS or next(model.parameters()).device.type != \
            LM_DEVICE:
        raise AssertionError("the model is not whisper-large-v3 at full "
                             "width on the card")

    # ---- prefill: the kernel path (clean), then the plain path ----
    spec = registry.input_specs(cfg, SHAPES["prefill_32k"])
    (B0, Sa, d), (_, S) = spec["frontend"].shape, spec["tokens"].shape
    B = PREFILL_B
    log(f"CUT: prefill of B={B} instead of input_specs(prefill_32k)'s "
        f"B={B0}: frames [{B}, {Sa}, {d}] and tokens [{B}, {S}]; the frames "
        f"(the stub frontend's embeddings, bf16 in the spec) are fp32 "
        f"N(0, 1), the model's dtype")
    frames = torch.randn((B, Sa, d), generator=gen, device=LM_DEVICE)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=LM_DEVICE, dtype=torch.int32)
    batch = {"frontend": frames, "tokens": tokens}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with last_flash_call(ops) as calls:
        logits, aux = encdec.forward(cfg, model, batch, use_kernel=True)
    torch.cuda.synchronize()
    stages["prefill (kernel path)"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"launches in the prefill forward: {launches}")
    check_path_kernels(launches, PATH10_KERNELS, "path 10")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected "
                             f"one a decoder layer ({cfg.n_layers})")
    vpad = -(-cfg.vocab // 16) * 16
    if logits.shape != (B, S, vpad) or not bool(
            torch.isfinite(logits).all()) or float(aux) != 0.0:
        raise AssertionError("prefill logits have the wrong shape or are "
                             "not finite")
    q, k, v, _ = calls[-1]  # the last decoder layer's call
    del calls
    ops.reset_launches()
    t0 = time.perf_counter()
    plain, _ = encdec.forward(cfg, model, batch)
    torch.cuda.synchronize()
    stages["prefill (plain path)"] = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain path launched kernels: {ops.LAUNCHES}")
    compare_logits(logits, plain, WHISPER_TOL,
                   "prefill, kernel path against plain path")
    teacher = logits[:, :WHISPER_DECODE_STEPS].clone()
    del logits, plain

    # ---- the encoder under ATTN_IMPL="flash" against the naive one ----
    enc = encdec.encode(cfg, model, frames)
    old = flags.ATTN_IMPL
    flags.ATTN_IMPL = "flash"
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with last_flash_call(ops) as calls:
            enc_flash = encdec.encode(cfg, model, frames)
        torch.cuda.synchronize()
        stages["encode under ATTN_IMPL='flash'"] = time.perf_counter() - t0
    finally:
        flags.ATTN_IMPL = old
    enc_launches = dict(ops.LAUNCHES)
    log(f"launches in the encoder under ATTN_IMPL='flash': {enc_launches}")
    check_path_kernels(enc_launches, PATH10_KERNELS, "path 10's encoder")
    if enc_launches["flash_attention"] != cfg.n_enc_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{enc_launches['flash_attention']} times in "
                             f"the encoder, expected {cfg.n_enc_layers}")
    diff = float((enc_flash - enc).abs().max())
    log(f"encoder states [{B}, {Sa}, {d}], flash against naive: max abs "
        f"difference {diff:.3g} (bound {WHISPER_TOL}; states std "
        f"{float(enc.std()):.3f})")
    if diff > WHISPER_TOL or not bool(torch.isfinite(enc_flash).all()):
        raise AssertionError("the flash encoder disagrees with the naive "
                             "one")
    eq, ek, ev, causal = calls[-1]  # the last encoder layer's call
    if causal:
        raise AssertionError("the encoder's flash call was causal")
    del calls, enc_flash

    # ---- decode against the teacher-forced forward ----
    state = encdec.init_decode_state(cfg, B, WHISPER_DECODE_STEPS,
                                     dtype=torch.float32, device=LM_DEVICE)
    state["enc_out"] = enc
    ops.reset_launches()
    t0 = time.perf_counter()
    steps = []
    for i in range(WHISPER_DECODE_STEPS):
        out, state = encdec.decode_step(cfg, model, state, tokens[:, i:i + 1])
        steps.append(out[:, 0])
    torch.cuda.synchronize()
    stages[f"{WHISPER_DECODE_STEPS} decode steps (B={B})"] = \
        time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"decode launched kernels: {ops.LAUNCHES}")
    compare_logits(torch.stack(steps, dim=1), teacher, WHISPER_TOL,
                   f"decode_step (enc_out from encode, fp32 state) against "
                   f"the teacher-forced forward at the first "
                   f"{WHISPER_DECODE_STEPS} positions")
    del steps, teacher, state, enc

    t0 = time.perf_counter()
    records = [flash_row("flash_attention_whisper", ops, q, k, v,
                         launches["flash_attention"], card,
                         "whisper_prefill")]
    records.append(flash_row("flash_attention_whisper_bf16", ops,
                             q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             launches["flash_attention"], card,
                             "whisper_prefill"))
    records.append(flash_row("flash_attention_whisper_enc", ops, eq, ek, ev,
                             enc_launches["flash_attention"], card,
                             "whisper_encode_flash", causal=False))
    records.append(flash_row("flash_attention_whisper_enc_bf16", ops,
                             eq.bfloat16(), ek.bfloat16(), ev.bfloat16(),
                             enc_launches["flash_attention"], card,
                             "whisper_encode_flash", causal=False))
    stages["the four kernel rows"] = time.perf_counter() - t0
    del q, k, v, eq, ek, ev, batch, frames, tokens

    # ---- serving: the caller writes the encoder's output ----
    kv = 2 * 2 * SERVE_SLOTS * Sa * d * cfg.n_kv_heads * cfg.hd * cfg.n_layers
    log(f"decode at {SERVE_SLOTS} slots: each step's cross-attentions "
        f"project the {Sa} encoder states to k and v anew in every layer, as "
        f"the reference does: {kv / 1e12:.3f} TFLOP of fp32 products "
        f"({kv / SCALAR_OPS_PER_S * 1e3:.3f} ms at 67 TFLOP/s) beside the "
        f"{step_bytes / 1e9:.2f} GB of decoder and head weights a step reads")
    serve_frames = torch.randn((SERVE_SLOTS, Sa, d), generator=gen,
                               device=LM_DEVICE)
    serve_and_check(cfg, model, ops, card, stages, step_bytes, WHISPER_SEED,
                    "path 10", WHISPER_TOL, frames=serve_frames)
    peak = torch.cuda.max_memory_allocated()
    for name, t in stages.items():
        log(f"[path 10] stage {name}: {t:.3f} s")
    log(f"peak device memory (path 10): {peak / 1e9:.2f} GB; {card}")
    del model, serve_frames
    gc.collect()
    torch.cuda.empty_cache()
    return records


def phase_dense_archs(ops, card):
    """Path 11: gemma-7b, starcoder2-3b, chatglm3-6b and internvl2-2b at
    full width, one after another, each freed before the next: random fp32
    weights, a prefill forward through the flash kernel (one launch a
    layer) against the plain path, starcoder2's once more under
    ATTN_IMPL="chunked" against the naive path, gemma's once more under
    the profiler, and the kernel's rows at each model's last call.
    Returns the JSON records of the eight rows."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import flags, registry, transformer

    full_fp32()
    shape = ShapeConfig("prefill", PREFILL_S, PREFILL_B, "prefill")
    log(f"CUT: each prefill takes input_specs of B={PREFILL_B} x "
        f"S={PREFILL_S} instead of prefill_32k's 32 x 32768 (internvl2: "
        f"its frontend rows and S minus them of tokens); the frontend "
        f"(bf16 stub embeddings in the spec) is fp32 N(0, 1), the model's "
        f"dtype")
    records = []
    for arch, (seed, want_n) in DENSE_ARCHS.items():
        cfg = registry.get(arch)
        short = arch.split("-")[0]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held0 = torch.cuda.memory_allocated()
        stages = {}
        t0 = time.perf_counter()
        gen = torch.Generator(device=LM_DEVICE)
        gen.manual_seed(seed)
        model = transformer.init_params(cfg, gen, device=LM_DEVICE)
        torch.cuda.synchronize()
        stages["init_params"] = time.perf_counter() - t0
        n = sum(p.numel() for p in model.parameters())
        weights = torch.cuda.memory_allocated() - held0
        log(f"path 11 model: {cfg.name}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads "
            f"of {cfg.hd}, d_ff {cfg.d_ff} ({cfg.act}), vocab {cfg.vocab}, "
            f"{'tied' if cfg.tie_embeddings else 'untied'}, rotary on "
            f"{cfg.rope_fraction:g} of each head, frontend {cfg.frontend}; "
            f"{n} parameters (the reference's init_params leaves: {want_n};"
            f" its param_count(): {int(cfg.param_count())}), "
            f"{weights / 1e9:.2f} GB fp32 on the card, random from "
            f"torch.Generator seed {seed}, built in "
            f"{stages['init_params']:.2f} s")
        if n != want_n or next(model.parameters()).device.type != LM_DEVICE:
            raise AssertionError(f"the model is not {arch} at full width on "
                                 f"the card")
        spec = registry.input_specs(cfg, shape)
        batch = {"tokens": torch.randint(0, cfg.vocab, spec["tokens"].shape,
                                         generator=gen, device=LM_DEVICE,
                                         dtype=torch.int32)}
        if "frontend" in spec:
            batch["frontend"] = torch.randn(spec["frontend"].shape,
                                            generator=gen, device=LM_DEVICE)
        log(f"{arch} prefill inputs: " + ", ".join(
            f"{k} {list(t.shape)}" for k, t in batch.items()))

        # ---- the kernel path (clean), then the plain path ----
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with last_flash_call(ops) as calls:
            logits, aux = transformer.forward(cfg, model, batch,
                                              use_kernel=True)
        torch.cuda.synchronize()
        stages["prefill (kernel path)"] = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        log(f"launches in the {arch} prefill forward: {launches}")
        check_path_kernels(launches, PATH11_KERNELS, f"path 11 ({arch})")
        if launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"flash_attention launched "
                                 f"{launches['flash_attention']} times, "
                                 f"expected one a layer ({cfg.n_layers})")
        vpad = -(-cfg.vocab // 16) * 16
        if logits.shape != (PREFILL_B, spec["tokens"].shape[1], vpad) or \
                not bool(torch.isfinite(logits).all()) or float(aux) != 0.0:
            raise AssertionError(f"{arch} prefill logits have the wrong "
                                 f"shape or are not finite")
        q, k, v, _ = calls[-1]  # the last layer's call
        del calls
        ops.reset_launches()
        t0 = time.perf_counter()
        plain, _ = transformer.forward(cfg, model, batch)
        torch.cuda.synchronize()
        stages["prefill (plain path)"] = time.perf_counter() - t0
        if any(ops.LAUNCHES.values()):
            raise AssertionError(f"plain path launched kernels: "
                                 f"{ops.LAUNCHES}")
        compare_logits(logits, plain, DENSE_LOGIT_TOL,
                       f"{arch} prefill, kernel path against plain path")
        del logits
        if arch == CHUNKED_ARCH:
            old = flags.ATTN_IMPL
            flags.ATTN_IMPL = "chunked"
            try:
                t0 = time.perf_counter()
                chunked, _ = transformer.forward(cfg, model, batch)
                torch.cuda.synchronize()
                stages["prefill (ATTN_IMPL='chunked')"] = \
                    time.perf_counter() - t0
            finally:
                flags.ATTN_IMPL = old
            if any(ops.LAUNCHES.values()):
                raise AssertionError(f"the chunked path launched kernels: "
                                     f"{ops.LAUNCHES}")
            compare_logits(chunked, plain, DENSE_LOGIT_TOL,
                           f"{arch} prefill, ATTN_IMPL='chunked' (512 x 512 "
                           f"blocks) against the naive path")
            del chunked
        del plain
        if arch == PROFILED_ARCH:
            profile(lambda: transformer.forward(cfg, model, batch,
                                                use_kernel=True),
                    f"{arch} prefill forward, kernel path")
        records.append(flash_row(f"flash_attention_{short}", ops, q, k, v,
                                 launches["flash_attention"], card,
                                 f"{short}_prefill"))
        records.append(flash_row(f"flash_attention_{short}_bf16", ops,
                                 q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 launches["flash_attention"], card,
                                 f"{short}_prefill"))
        del q, k, v, batch
        peak = torch.cuda.max_memory_allocated()
        for name, t in stages.items():
            log(f"[path 11, {arch}] stage {name}: {t:.3f} s")
        log(f"peak device memory (path 11, {arch}): {peak / 1e9:.2f} GB; "
            f"{card}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return records


WATCHED = ("embed", "layers.0.attn.wq")  # leaves held to a CPU update


def _host(t):
    """A host copy (never a view, also of a CPU tensor)."""
    return t.detach().to("cpu", copy=True)


def _host_moment(st, opt):
    return opt.MomentState(_host(st.value), None if st.scale is None
                           else _host(st.scale))


def _train_steps(cfg, model, state, adam, batches, launch, opt, label,
                 check_step=None):
    """Runs launch.train_step once a batch, timing each step's forward,
    backward and apply_updates with CUDA events.  At `check_step` (0-
    based) the watched leaves' p, g, m and v are copied to the host
    between backward and apply_updates, and their updated p, m and v after
    it, for `_check_update_on_cpu`.  Returns (losses, gnorms, per-phase ms
    a step, the copies)."""
    losses, gnorms, times, copies = [], [], [], {}
    params = opt.named(model)

    def grab(when):
        copies[when] = {n: (_host(params[n]),
                            None if params[n].grad is None
                            else _host(params[n].grad),
                            _host_moment(state["m"][n], opt),
                            _host_moment(state["v"][n], opt))
                        for n in WATCHED}

    for i, batch in enumerate(batches):
        marks = [torch.cuda.Event(enable_timing=True)]

        def on_phase(name, i=i):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            if name == "backward" and i == check_step:
                grab("before")

        marks[0].record()
        loss, gnorm = launch.train_step(cfg, model, state, {"tokens": batch},
                                        adam, on_phase=on_phase)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        times.append(ms)
        if i == check_step:
            grab("after")
            copies["step"] = int(state["step"])
            copies["gnorm"] = _host(gnorm)
        log(f"[{label}] step {i + 1}: loss {losses[-1]:.6f}, gnorm "
            f"{gnorms[-1]:.6f}, forward {ms[0]:.2f} ms, backward "
            f"{ms[1]:.2f} ms, apply_updates {ms[2]:.2f} ms")
        # a non-finite gradient anywhere makes the global norm non-finite
        if not (np.isfinite(losses[-1]) and np.isfinite(gnorms[-1])):
            raise AssertionError(f"{label}: step {i + 1} has a non-finite "
                                 f"loss or gradient")
    return losses, gnorms, times, copies


def _check_update_on_cpu(copies, adam, opt, label):
    """The card's apply_updates of the watched leaves against the same
    update on the CPU from the same p, g, m and v, with the card's step
    and global norm: p within UPDATE_TOL, fp32 moments too, int8 moments
    within one quantum."""
    step = torch.tensor(copies["step"], dtype=torch.int32)
    clip = opt.clip_factor(copies["gnorm"], adam)
    corrections = opt.bias_corrections(step, adam)
    for n in WATCHED:
        p, g, m, v = copies["before"][n]
        opt.update_leaf(p, g, m, v, clip, corrections, adam)
        card_p, _, card_m, card_v = copies["after"][n]
        err = max_abs_err(p, card_p)
        if adam.quantize_moments:
            m_err = max(int((a.value.int() - b.value.int()).abs().max())
                        for a, b in ((m, card_m), (v, card_v)))
            m_ok, m_bound = m_err <= 1, "1 quantum"
        else:
            m_err = max(max_abs_err(m.value, card_m.value),
                        max_abs_err(v.value, card_v.value))
            m_ok, m_bound = m_err <= UPDATE_TOL, UPDATE_TOL
        log(f"[{label}] apply_updates of {n} {list(p.shape)} at step "
            f"{copies['step']}: card against CPU, parameters {err:.3g} "
            f"(bound {UPDATE_TOL}), moments {m_err:.3g} (bound {m_bound})")
        if err > UPDATE_TOL or not m_ok:
            raise AssertionError(f"{label}: apply_updates of {n} on the "
                                 f"card differs from the CPU's")


def _grad_witness(cfg, batch, launch, layers, transformer):
    """fp32 gradients of the training loss against float64's, the same
    weights GRAD_WITNESS_LAYERS layers deep at full width: each leaf
    within GRAD_WITNESS_TOL of its max |g|.  The float64 loss is its own
    cross-entropy in float64 (layers.cross_entropy computes in fp32)."""
    cut = dataclasses.replace(cfg, n_layers=GRAD_WITNESS_LAYERS)
    gen = torch.Generator(device=LM_DEVICE)
    gen.manual_seed(TRAIN_SEED)
    m32 = transformer.init_params(cut, gen, device=LM_DEVICE)
    m64 = copy.deepcopy(m32).to(torch.float64)
    transformer.loss_fn(cut, m32, {"tokens": batch}).backward()
    logits, _ = transformer.forward(cut, m64, {"tokens": batch}, grad=True)
    targets, mask = layers.next_token_targets(batch)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    mask = mask.double()
    (((logz - gold) * mask).sum() / mask.sum()).backward()
    del logits, logz, gold
    worst = (0.0, "")
    for (n, p32), p64 in zip(m32.named_parameters(), m64.parameters()):
        g64 = p64.grad
        rel = float((p32.grad.double() - g64).abs_().max()
                    / g64.abs().max().clamp(min=1e-300))
        worst = max(worst, (rel, n))
    log(f"path 12a float64 witness: {cut.name} {GRAD_WITNESS_LAYERS} layers "
        f"deep at full width on one batch; the worst fp32 gradient leaf is "
        f"{worst[1]} at {worst[0]:.3g} of its max |g| from float64 (bound "
        f"{GRAD_WITNESS_TOL})")
    if worst[0] > GRAD_WITNESS_TOL:
        raise AssertionError("path 12a: an fp32 gradient strays from "
                             "float64")
    del m32, m64


def phase_train_llama(ops, card, launch, opt, layers, registry,
                      transformer, synthetic_token_stream):
    """Path 12a: llama3.2-3b at full width, the step train() runs, with
    fp32 and then int8 moments."""
    cfg = registry.get(TRAIN_ARCH)
    tcfg = launch.TrainConfig()
    B, S = tcfg.batch, tcfg.seq
    log(f"CUT: path 12a runs launch.train_step, the step train() runs, not "
        f"train() itself: train()'s final blocking save would write the "
        f"parameters and fp32 moments (38.5 GB) through host memory and "
        f"disk that this machine is not known to have; 12b runs train() end "
        f"to end at {RESUME_ARCH}")
    stream = synthetic_token_stream(cfg.vocab, B, S, seed=TRAIN_SEED)
    n_batches = TRAIN_STEPS + TRAIN_PROFILED_STEPS
    batches = [next(stream)["tokens"].to(LM_DEVICE) for _ in range(n_batches)]
    stream.close()
    log(f"path 12a batches: {n_batches} of B={B} x S={S} tokens "
        f"(TrainConfig's defaults) from synthetic_token_stream seed "
        f"{TRAIN_SEED}")
    fp32_losses = None  # the fp32 run's, beside the int8 run's
    stages = {}
    for quantize in (False, True):
        kind = "int8" if quantize else "fp32"
        label = f"path 12a, {kind} moments"
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        gen = torch.Generator(device=LM_DEVICE)
        gen.manual_seed(TRAIN_SEED)
        model = transformer.init_params(cfg, gen, device=LM_DEVICE)
        adam = opt.AdamConfig(quantize_moments=quantize)
        state = opt.init_state(model, adam)
        torch.cuda.synchronize()
        stages[f"init_params and init_state ({kind})"] = \
            time.perf_counter() - t0
        n = sum(p.numel() for p in model.parameters())
        weights = sum(p.nbytes for p in model.parameters())
        values = sum(st.value.nbytes for k in ("m", "v")
                     for st in state[k].values())
        scales = sum(st.scale.nbytes for k in ("m", "v")
                     for st in state[k].values() if st.scale is not None)
        log(f"{label}: {cfg.name} at full width, {n} parameters "
            f"({weights / 1e9:.2f} GB fp32), tied; m and v "
            f"{values / 1e9:.2f} GB {kind} + {scales / 1e9:.2f} GB of "
            f"scales; with the gradients "
            f"{(2 * weights + values + scales) / 1e9:.2f} GB of state; built "
            f"in {time.perf_counter() - t0:.2f} s")
        if n != TRAIN_PARAMS or next(model.parameters()).device.type != \
                LM_DEVICE:
            raise AssertionError("the model is not llama3.2-3b at full "
                                 "width on the card")
        # the first step's loss against a no-grad forward on its batch
        logits, aux = transformer.forward(cfg, model, {"tokens": batches[0]})
        targets, mask = layers.next_token_targets(batches[0])
        want0 = float(layers.cross_entropy(logits, targets, mask)
                      + 0.01 * aux)
        del logits, aux
        ops.reset_launches()
        t0 = time.perf_counter()
        losses, _, times, copies = _train_steps(
            cfg, model, state, adam, batches[:TRAIN_STEPS], launch, opt,
            label, check_step=1)
        wall = time.perf_counter() - t0
        stages[f"{TRAIN_STEPS} steps ({kind})"] = wall
        launches = dict(ops.LAUNCHES)
        check_path_kernels(launches, (), "path 12a")
        rel = abs(losses[0] - want0) / abs(want0)
        log(f"{label}: step 1's loss {losses[0]:.6f} against a no-grad "
            f"forward's {want0:.6f}: relative difference {rel:.3g} (bound "
            f"{TRAIN_LOSS_TOL}); loss {losses[0]:.6f} -> {losses[-1]:.6f} "
            f"over {TRAIN_STEPS} steps; no kernel launched")
        if rel > TRAIN_LOSS_TOL:
            raise AssertionError(f"{label}: the step's loss is not the "
                                 f"forward's")
        if quantize:
            # the reference's int8 v flushes a block's entries below its
            # max / 254 to 0; beside a nonzero m such an entry's step is
            # |mh| / (sqrt(vh) + eps), far above Adam's ~1
            flushed = sum(int(((state["v"][k].value == 0)
                               & (state["m"][k].value != 0)).sum())
                          for k in state["v"])
            trend = "fell" if losses[-1] < losses[0] else "did not fall"
            log(f"{label}: the loss {trend} ({losses[0]:.6f} -> "
                f"{losses[-1]:.6f}; fp32 moments {fp32_losses[0]:.6f} -> "
                f"{fp32_losses[-1]:.6f}); "
                f"{flushed} of {n} entries ({100 * flushed / n:.2f}%) hold "
                f"an int8 v of 0 beside a nonzero m (the reference's "
                f"linear absmax quantization, ROADMAP Queue 3), so the "
                f"loss is held to be finite, not to fall")
        elif not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: the loss did not fall")
        else:
            fp32_losses = losses
        timed = np.asarray(times[TRAIN_TIMED_FROM:])
        med = np.median(timed, axis=0)
        step_ms = float(np.median(timed.sum(axis=1)))
        peak = torch.cuda.max_memory_allocated()
        log(f"{label}: {step_ms:.2f} ms a step (median of steps "
            f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS}, CUDA events): forward "
            f"{med[0]:.2f}, backward {med[1]:.2f}, apply_updates "
            f"{med[2]:.2f} ms; {B * S / step_ms * 1e3:.0f} tokens/s; "
            f"{TRAIN_STEPS} steps in {wall:.2f} s (host clock); peak device "
            f"memory {peak / 1e9:.2f} GB ({(peak - held0) / 1e9:.2f} GB above "
            f"what was held before); {card}")
        t0 = time.perf_counter()
        _check_update_on_cpu(copies, adam, opt, label)
        del copies
        stages[f"apply_updates on the CPU ({kind})"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        profile(lambda: [launch.train_step(cfg, model, state, {"tokens": b},
                                           adam)
                         for b in batches[TRAIN_STEPS:]],
                f"{TRAIN_PROFILED_STEPS} training steps, {label}")
        stages[f"{TRAIN_PROFILED_STEPS} profiled steps ({kind})"] = \
            time.perf_counter() - t0
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _grad_witness(cfg, batches[0], launch, layers, transformer)
    torch.cuda.synchronize()
    stages["float64 witness"] = time.perf_counter() - t0
    for name, t in stages.items():
        log(f"[path 12a] stage {name}: {t:.3f} s")
    del batches
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_resume(ops, card, launch, opt, Checkpointer):
    """Path 12b: launch.train() end to end at xlstm-125m full width, in a
    $TMPDIR checkpoint directory: 6 steps with a checkpoint every 3, a run
    to 9 that must resume at 6 with the parameters and optimizer state
    bit-equal to the first run's, and a run stopped by SIGTERM from a
    timer thread with a final checkpoint of the step it reached."""
    import signal
    import threading

    seen = []  # (model, opt_state) of each train_step call
    start = {}  # the host copy of the state a run's first step starts from
    step_fn = launch.train_step

    def host_state(model, state):
        return ({n: _host(p) for n, p in model.named_parameters()},
                {k: {n: _host_moment(st, opt) for n, st in state[k].items()}
                 for k in ("m", "v")}, int(state["step"]))

    def spy(cfg, model, state, batch, adam, **kw):
        if not seen:
            start["state"] = host_state(model, state)
        seen.append((model, state))
        return step_fn(cfg, model, state, batch, adam, **kw)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    launch.train_step = spy
    timer = None
    try:
        for name, steps, every in (("run 1", 6, 3), ("run 2", 9, 3),
                                   ("run 3", 1_000_000, 1_000_000)):
            tcfg = launch.TrainConfig(steps=steps, ckpt_every=every,
                                      ckpt_dir=tmp, log_every=1)
            seen.clear()
            if name == "run 3":
                # the timer starts at the first step, when the hook is in
                def first_step(*a, **kw):
                    nonlocal timer
                    if timer is None:
                        timer = threading.Timer(
                            SIGTERM_AFTER_S, os.kill,
                            (os.getpid(), signal.SIGTERM))
                        timer.start()
                    return spy(*a, **kw)
                launch.train_step = first_step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, losses, monitor = launch.train(
                RESUME_ARCH, tcfg, smoke=False, seed=RESUME_SEED,
                device=LM_DEVICE)
            wall = time.perf_counter() - t0
            n = sum(p.numel() for p in model.parameters())
            ck = Checkpointer(f"{tmp}/{RESUME_ARCH}")
            log(f"path 12b {name}: train({RESUME_ARCH!r}, steps={steps}, "
                f"ckpt_every={every}) at full width ({n} parameters) on the "
                f"card: {len(losses)} steps in {wall:.2f} s, losses "
                f"{[round(x, 4) for x in losses]}, checkpoints "
                f"{ck.list_steps()}, stragglers flagged "
                f"{len(monitor.flagged)} {monitor.flagged}, peak device "
                f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
                f"{card}")
            if n != XLSTM_PARAMS or not all(np.isfinite(losses)):
                raise AssertionError(f"path 12b {name}: not {RESUME_ARCH} "
                                     f"at full width, or a loss is not "
                                     f"finite")
            if name == "run 1":
                if len(losses) != 6 or ck.latest_step() != 6:
                    raise AssertionError("path 12b run 1 did not take 6 "
                                         "steps and save step 6")
                final = host_state(*seen[-1])
            elif name == "run 2":
                if len(losses) != 3 or ck.latest_step() != 9:
                    raise AssertionError("path 12b run 2 did not resume at "
                                         "step 6 and save step 9")
                params, moments, step = final
                got_p, got_m, got_step = start["state"]
                same = got_step == step == 6 and all(
                    torch.equal(got_p[n], t) for n, t in params.items()) \
                    and all(torch.equal(got_m[k][n].value, st.value)
                            for k in ("m", "v")
                            for n, st in moments[k].items())
                log(f"path 12b run 2: resumed at step 6, the parameters and "
                    f"moments bit-equal to run 1's final ones: {same}")
                if not same:
                    raise AssertionError("path 12b: the resumed state is "
                                         "not run 1's final state")
            else:
                stopped = 9 + len(losses)
                if ck.latest_step() != stopped or len(losses) < 1:
                    raise AssertionError(f"path 12b run 3: no final "
                                         f"checkpoint of step {stopped} "
                                         f"after SIGTERM")
                log(f"path 12b run 3: SIGTERM after {SIGTERM_AFTER_S} s "
                    f"stopped the run at step {stopped} with a blocking "
                    f"checkpoint of it")
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if timer is not None:
            timer.cancel()
        launch.train_step = step_fn
        shutil.rmtree(tmp, ignore_errors=True)


def phase_train(ops, card):
    """Path 12: training (12a llama3.2-3b, 12b xlstm-125m's train()).
    Runs no kernel (the training forward is the plain path, as the
    reference's is) and returns no row."""
    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.launch import train as launch
    from repro_torch.models import layers, registry, transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import Checkpointer

    full_fp32()
    t0 = time.perf_counter()
    phase_train_llama(ops, card, launch, opt, layers, registry, transformer,
                      synthetic_token_stream)
    log(f"path 12a wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ops.reset_launches()
    phase_train_resume(ops, card, launch, opt, Checkpointer)
    check_path_kernels(dict(ops.LAUNCHES), (), "path 12b")
    log(f"path 12b wall: {time.perf_counter() - t0:.1f} s")
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-pairs", type=int, default=DEFAULT_PAIRS,
                    help=f"read pairs to simulate (default {DEFAULT_PAIRS})")
    ap.add_argument("--num-genomes", type=int, default=DEFAULT_GENOMES,
                    help=f"genomes besides the strains (default "
                         f"{DEFAULT_GENOMES})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this script measures the "
              "port on the card only", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Assembler, AssemblyPlan, Local
    from repro_torch.core import dbg
    from repro_torch.core.kmer_analysis import ExtensionPolicy
    from repro_torch.data import mgsim
    from repro_torch.kernels import build, ops
    api = (Assembler, AssemblyPlan, Local)

    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build.build_all()
    rep = build.last_build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc, parallel: {rep.get('compiled')})")
    tensor_core_report(build)
    KERNEL_OPS.update(kernel_ops(build))

    t0 = time.perf_counter()
    comm = mgsim.sample_community(0, num_genomes=args.num_genomes,
                                  genome_len=(10_000, 30_000),
                                  strain_pairs=4)
    reads, _ = mgsim.generate_reads(1, comm, num_pairs=args.num_pairs,
                                    read_len=150, insert_mean=400,
                                    insert_sd=30, err_rate=0.002)
    content = sum(len(g) for g in comm.genomes)
    log(f"data: {len(comm.genomes)} genomes, {content} bp, "
        f"{reads.num_reads} reads x {reads.max_len} bp "
        f"({reads.num_reads * reads.max_len / content:.1f}x), "
        f"generated in {time.perf_counter() - t0:.1f} s on the host")
    log("CUT: 20 genomes (+4 strains) and 75000 read pairs instead of 40 "
        "and 120000: with those the first round's traversal finds 5893 "
        "chains, over the contig_cap of 4096 that the reference's "
        "single-shard (contig, mer) tag space allows")
    if args.num_pairs != DEFAULT_PAIRS:
        log(f"CUT: num_pairs {args.num_pairs} instead of {DEFAULT_PAIRS}")
    if args.num_genomes != DEFAULT_GENOMES:
        log(f"CUT: num_genomes {args.num_genomes} instead of "
            f"{DEFAULT_GENOMES}")

    records = phase_contig_rounds(api, ops, dbg, reads, comm)
    path2_records, path2 = phase_assemble(api, ops, reads, comm)
    records += path2_records
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path3_records, path3 = phase_stream(api, ops, reads, comm, path2,
                                            tmp)
        records += path3_records
        mesh_records, path6a = phase_mesh(api, ops, reads, comm, path2,
                                          path3, tmp)
        records += mesh_records
        small = phase_small(api, mgsim, ExtensionPolicy)
        small_stream = phase_small_stream(api, small["reads"])
        phase_serving(api, ops, reads, path2, path3, path6a, small,
                      small_stream, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del path2, path3, path6a, small, small_stream
    gc.collect()
    torch.cuda.empty_cache()
    for path, phase in ((4, phase_lm), (5, phase_hybrid), (8, phase_moe),
                        (9, phase_xlstm), (10, phase_whisper),
                        (11, phase_dense_archs), (12, phase_train)):
        t0 = time.perf_counter()
        records += phase(ops, card)
        log(f"path {path} wall: {time.perf_counter() - t0:.1f} s")

    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
