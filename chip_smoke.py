#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

Phases, in order; each prints one JSON line. A closeness check that
fails prints its own line and the script goes on, so one disagreement
hides no later phase; after the last phase the failed checks are
listed and the script exits 1 without its result lines. Any other
failure exits non-zero at once:

1. device  — ``torch.cuda.is_available()``, the card's name and power
   limit from nvidia-smi, the torch / CUDA versions.
2. build   — the CUDA kernels from ``paddle_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together); ``ptxas -v``
   prints every kernel's registers, spills and shared memory to stderr,
   and the build line carries those of the backward's tensor-core
   kernels and of the fused bottleneck, whose served instantiations must
   not spill.
3. kernels — each kernel against its plain PyTorch version on the card
   at the serving, training and ResNet paths' shapes, in fp32 and bf16
   (and the attention kernels and ``adam_update`` in fp16),
   with its tolerance, each check on inputs from its own generator
   (paged_decode also against its split emulation, and bit for bit
   alone against batched and against NaN where it must not read; the
   fused bottleneck also against the emulation of its tiles, at the
   ResNet-50 shapes and at N=1 blocks of a 896x896 input; adam_update,
   the port's own kernel, bitwise against the eager chain it replaced
   over 3 steps in each storage variant and decay, and one call over a
   list bitwise against one call a tensor); its
   median time over 20 launches (CUDA events, L2 flushed and a device
   spin queued before each launch, so the host's work stays out of the
   window; ``fused_argmax`` index-exact at 1-257 rows, both layouts,
   with and without bias, fp32 / mixed / bf16 operands, an odd vocab and
   planted ties, NaNs and infinities, and timed at 1, 8, 40 (the
   speculative verify) and 128 rows and in bf16 at 8;
   ``paged_decode`` also with every other row masked to the scratch
   page at length 0, live rows bitwise), the plain version's, one PyTorch yardstick call's, and the
   least time the card could take: the larger of the bytes at 3.35 TB/s
   and the products on the tensor cores (fp32 as 3xTF32, three TF32
   products at 495 TFLOP/s; bf16 at 989 TFLOP/s). The dQ and dK/dV
   passes are timed in bf16 too at the headline step's shape. fp16
   (``kernels_fp16``): the forward, the dQ and dK/dV passes, the single
   pass and the folded backward at train_amp's shapes against their
   plain versions within ``FP16_ATOL`` (the ``BF16_ATOL`` limits scaled
   by fp16's unit roundoff, 2^-11 over 2^-8) before the rounding, timed
   beside SDPA in fp16 and their fp16 bounds (989 TFLOP/s);
   ``adam_update``'s fp16 variant bitwise against its plain version.
4. engine  — GPT-1.3B (seed-0 random weights, fp32) through the paged
   continuous-batching engine: the kernel path against the plain path
   on prefill and decode, then 8 requests whose prompts span every
   prefill bucket, with the serving kernels' launch counts read from
   that run; then the engine's other two kernel paths
   (``fused_step=False`` and ``kv_int8``), each against its plain run;
   then 32 slots (``engine_wide``: 32 prompts of 64-512 tokens, all
   decoding at once) with the fused head against the unfused head,
   tokens bitwise, ``fused_argmax`` at 32 rows, and a profile of the
   head's device ms a decode step.
5. server  — the newline-JSON server on localhost with the same model
   (its prefix cache on, the default): 4 generate requests (2
   streaming), health, stats, drain, leak_check.
5b. engine_prefix — the prefix cache: a 1024-token system prompt (16
   pages) shared by 8 requests (tails of 40-540 tokens, 32 new tokens
   each, 8 slots, 96 pages), the cache on and off, each through the
   kernels and the plain versions: 16 cached pages a hit, a hit rate
   above 0, the cache audits, the serving kernels launched on the cached
   kernel run (training kernels at 0), the chained prefill's last-row
   logits within ``MODEL_REL_TOL`` of a fresh prefill of the whole
   prompt and of its plain path; token agreement on against off,
   prefill ms, TTFT p50/p99, tokens/s, the decode step, peak memory.
5c. engine_spill — a ~2 GB host spill tier and a 40-page pool: a second
   system prompt's wave evicts the first one's chain into the tier, then
   the first wave runs again and restores it: pages restored, each
   re-read byte-equal to its blob, no leak; ``_read_page`` ms a page,
   ``_splice_page`` ms a run, token agreement with no tier.
5d. server_resurrect — 4 streaming requests of 50-1200 tokens; the
   ``engine.step`` fault site fails two steps once all hold tokens
   (``max_engine_errors=2``): one resurrection, every stream equal to
   its reply, every reply ``replayed``, the leak check, a later request
   served; a prefill of prompt + emitted token against the decode
   step's logits there, within ``MODEL_REL_TOL``; token agreement with a
   fault-free run. The fault injector is reset after it.
5e. engine_chunked — chunked prefill at 256 tokens a chunk: 8 requests
   of 300-1700 tokens, 32 new tokens, 8 slots, chunked and whole: each
   final chunk's last-row logits within ``MODEL_REL_TOL`` of a whole
   prefill, the serving kernels launched on the chunked run (the fresh
   first chunks through ``attention_fwd``), no leak; token agreement,
   fresh and chained chunk ms, the decode step with chunks in flight,
   TTFT chunked and whole, the prefill debt by step; then two identical
   prompts with the cache on fold pages (``dedup_hits`` > 0) and equal
   the tokens of ``dedup=False``.
5f. engine_spec — speculative decoding, k=4, 8 requests of 130-800
   tokens, 32 new tokens, with the n-gram draft, a ModelDraft of the
   target itself (window 64) and an always-wrong draft: each verify
   position's logits within ``MODEL_REL_TOL`` of the vanilla decode
   step's, ``fused_argmax`` launched once a prefill and once a verify
   (40 rows), the always-wrong draft accepting nothing, no leak;
   acceptance rate, tokens a step, verify ms and agreement with vanilla;
   and with an oracle draft (the vanilla run's own tokens) what full
   acceptance gives.
5g. server_chunked_spec — a server with both: 4 requests (2 streaming),
   then ``stats`` and ``leak_check``.
5h. engine_multi_step — multi-step decode (one CUDA graph of the decode
   iteration, replayed N times a launch): the engine phase's 8 prompts
   at ``multi_step`` 1, 4 and 8, and with an EOS that the N=1 run emits
   mid-launch; chunk 256 at N=8 on the ``engine_chunked`` prompts
   against chunked N=1 and whole prefill; n-gram speculation k=4 at N=4
   on the ``engine_spec`` prompts against vanilla decoding; bf16 and
   int8 pools at N=1 and N=8 (4 layers). Gates: every token list
   bitwise its reference's, the graph path's per-replay launch counts
   show the three decode kernels (speculation: ``fused_argmax`` and no
   decode kernel), a profiled replay names them, the ticket buffers
   read zero. Reports tokens/s, ms a token, launches, iterations a
   launch, masked iterations, the graphs' kernel nodes, and over steady
   launches the host's launch calls a token and the device idle share.
5i. server_multi_step — the server as ``--multi-step 8`` builds it (4
   layers): two streaming requests, two failed steps, one resurrection
   onto the rebuilt multi-step engine; streams equal replies, the leak
   check, the decode kernels launched.
5j. server_observe_swap — the server's observability ops and weight
   hot-swap at full width (``multi_step=8``, the prefix cache on): seed-1
   weights B written by ``ResilientCheckpointManager`` and restored
   (save and load seconds); B's tokens at ``multi_step`` 1 and 8 bitwise
   equal; a server on seed-0 weights A answers ``profile`` (a 300 ms
   capture during a decoding wave: the decode kernels named in the
   chrome trace, the card's memory stats), ``capacity``, ``trace``
   (per-token rows, ``program_costs``), ``export`` and ``slo``; the
   ``swap`` op to B: bitwise B's tokens from the same captured graphs,
   the serving kernels launched after it, 0 hit pages for prompts cached
   under A; a truncated shard refused typed with B still serving; an
   eager engine's ``swap_weights`` A -> B bitwise B's tokens, and its
   decode ``program_costs`` beside one profiled step's device ms.
5l. fleet — replicas as processes on the one card (``python -m
   paddle_tpu_torch.serving.server``, GPT-1.3B fp32 seed 0, 8 slots,
   page 64, 96 pages, a 4 GB host tier) under a ``Supervisor`` behind a
   ``FailoverRouter`` in this process: roles prefill + decode take 2
   keyed prompts of 1024 and 1600 tokens (prefill_only on one, a fetch_from
   handoff on the other): every chain handed off and restored, no
   failure, no leak; handoff ms and bytes, client TTFT / TPOT, the
   prefill replica's engine stall during an export, token agreement with
   the in-process engine; a profile window on each replica names the
   decode kernels and ``attention_fwd`` in its trace; one handoff with
   int8 blobs; an in-process pair holds restored pages byte-equal to the
   exported blobs. Then two mixed replicas: a keyed stream whose replica
   is killed mid-stream completes on the survivor equal to the
   in-process engine's tokens, the replica respawns, fresh prompts equal
   the in-process engine's; ``roll_fleet`` onto a seed-1 checkpoint
   (canary 2 s) under a streaming client: generation 1 everywhere, no
   failed request, a fresh prompt equal to the in-process engine on
   seed-1 weights; ``fleet_stats`` and ``fleet_capacity`` through the
   router.
5m. fleet_autoscale — the autoscaler at the same width: (a) in this
   process, one replica under a ``Supervisor`` with an ``Autoscaler``
   and a ``FailoverRouter``: 4 keyed prompts of 130-190 tokens (16 new
   tokens) served, a forced ``scale_up`` (its seconds), a profiled
   64-token stream of a fifth prompt on the spawned replica naming the
   decode kernels in its trace, served again, a forced ``scale_down``
   (drain, the fifth prompt's chain handed off, kill), served again and
   the fifth prompt on the survivor: every reply equals the
   in-process engine's tokens, the journal holds a spawn and a drain and
   lints clean, the survivor's leak_check; (b) ``paddle_tpu_torch.tools.
   chaos_serving.run_autoscale_chaos`` (the supervisor SIGKILLed
   mid-spawn and mid-scale-down, restarted on its journal; 6 keyed
   requests of 2-3 pages) and (c) ``run_roll_chaos`` (the supervisor
   SIGKILLed mid-roll, a corrupt checkpoint refused, a replica SIGKILLed
   mid-roll): each report ok, 2 recoveries in (b), no stranded process,
   no generation failure; the supervisor's restart-to-serving seconds
   and each journaled action's wall seconds; no supervisor process ever
   holds the card's device files open (``nvidia-smi`` here names every
   process pid 1, so the check reads ``/proc/<pid>/fd``), each
   replica's largest reserved memory, and the card's.
5k. generate — ``GPTForCausalLM.generate`` on the same model, 4 prompts
   of 1024 tokens: the one-launch mode over static, paged and int8-paged
   caches (one CUDA graph of the decode step, replayed a token), the
   chunked mode and the eager loop, each through the kernels and the
   plain versions (prefill logits within ``MODEL_REL_TOL``, first tokens
   equal, launch gates with the replays counted); chunked bitwise the
   static mode, the fused head bitwise the unfused one; B=1 paged runs
   at 512 and 128 tokens; seeded top-k sampling (one stream a seed,
   every token in its step's top 40, ``top_k=1`` greedy); then
   ``convert_to_weight_only_int8`` (96 layers; logits within 0.05 of
   the float model's; chunked bitwise whole; a ``multi_step=4`` engine
   captured before the conversion recaptures; an 8-slot engine without
   ``decode_out_proj``). Reports ms a decode step per mode and peak
   memory. The one-launch mode's program cache keeps one program a
   cache kind: a sweep of four signatures of each kind leaves one live
   program a kind and the memory of one (``gen_cache_sweep``). The
   model is converted in place: it is this script's last use of it.
6. train   — GPT-1.3B training (fp32, dropout 0, ``AdamW(1e-4)``):
   one forward+backward at full depth, B=2, S=2048, through the kernels
   against the plain versions (loss and every parameter's gradient);
   ``TrainStep.multi_step`` over 6 steps on a repeated batch (losses,
   ms per step, tokens/s, peak memory, the backward kernels' launch
   counts, ``adam_update`` among them), one step repeated bitwise from
   one state and once more under ``fuse_optimizer`` (the same bits, one
   ``adam_update`` launch a dtype group); then steps at S=512 and S=256
   and with remat + chunked loss, with and without
   ``remat_save_attention`` (4 layers) against their plain steps, each
   then timed over 5 steps; then the three remat settings' gradients
   (saved attention bitwise remat's), forward launches and memory.
6b. train_bf16 — the JAX headline step (``bench.py:119-138``) at full
   depth: GPT-1.3B, V=32768, the bf16 recipe, bf16 Adam slots, B=2,
   S=2048: one forward+backward against the plain path within limits
   derived from bf16's unit roundoff, ``multi_step`` over 6 steps (ms,
   tokens/s, peak memory, MFU against 989 TFLOP/s), a bitwise repeat, a
   ``fuse_optimizer`` step and a profiled step.
6c. train_amp — the rest of the training surface at GPT-1.3B's widths
   (V=32768, 24 layers, fp32 master weights, B=2, S=2048,
   ``AdamW(1e-4)``): (a) ``auto_cast(dtype="bfloat16")`` O1 under
   ``TrainStep``: one forward+backward through the kernels against the
   plain path within the ``BF16_*`` limits (gradients fp32), then
   ``multi_step`` over 6 steps (losses fall, ms, tokens/s, peak memory,
   MFU, the attention kernels in bf16 and ``adam_update`` in fp32
   launched, the casts of one forward); (d) ``Lookahead(k=2)`` around
   its AdamW and an EMA over 3 more steps: the fast weights are the slow
   ones after a sync, EMA ``apply`` + ``restore`` is bitwise the
   identity, an evaluation inside ``apply_guard`` runs on the shadow;
   (b) ``auto_cast(dtype="float16")`` with ``GradScaler()`` at its
   defaults as an eager loop of 8 steps, an inf planted in one step's
   gradient (that step leaves every parameter bitwise unchanged and the
   optimizer's step count unmoved): the scale's path, the skipped steps,
   the fp16 attention launches; one fp16 step at 4 layers at S=512 and
   S=256 (the single pass and the folded backward); (c)
   ``decorate(level="O2", dtype="float16")`` with ``GradScaler()`` for 2
   steps: ``adam_update`` in (fp16, fp16); (e) ``DGCMomentum`` at 4
   layers for 6 steps after a ``rampup_begin_step=2`` warm-up, the DGC
   paper's sparsity ramp: each tensor's strided sample at its threshold
   holds 1 - sparsity within two sample elements; the applied share of
   the whole tensor reported beside it; ms a step beside
   ``Momentum``'s.
7. resnet  — ResNet-50 eval inference (NHWC, 224x224, N=128, fp32,
   seed-0 weights, seeded BN statistics) on the fused-bottleneck kernel
   path, the plain path and the ``fuse_conv_bn`` path: logits against
   the plain path, 5 kernel launches per forward, ms per forward,
   imgs/s, peak memory, N=1 latency, and a profiled forward of the
   kernel and plain paths.
7e. vision_folder — the slice's path: 400 seeded uint8 ``.npy`` images
   (short sides 240-320, 10 classes) under ``build/vision-folder/``,
   read by ``DatasetFolder(loader=np.load)`` through
   ``RandomResizedCrop(224)``, ``RandomHorizontalFlip``, ``ToTensor``
   and ``Normalize`` and ``io.DataLoader(batch_size=128, shuffle=True,
   num_workers=4, drop_last=True)``; ResNet-50 at config 1 with
   ``nn.CrossEntropyLoss(label_smoothing=0.1)`` for 3 steps (finite
   losses, no port kernel launched); the loader's first-batch latency
   and steady ms a batch over 12 batches, each step's wait and ms and
   the device's idle share with the iterator warm; the trained weights on
   the eval transforms' batch through ``fused_bottleneck`` (5 launches
   a forward) against the plain path, fp32 and bf16.
7f. vision_ops — the slice's losses, resampling ops, vision extras and
   ``yolo_box`` on the card against the CPU in float64 (``interpolate``
   in every mode, ``grid_sample``, ``deformable_conv``, the RoI pools,
   ``yolov3_loss``, ``ctc_loss`` among them), each within its stated
   tolerance.
8. bert_pretrain — BERT-base MLM pretraining, the JAX package's
   benchmark config 2 (``bench_all.py:149-227``; seed 0, dropout 0,
   76 masked slots a sequence, S=512): (a) fp32 at full width and depth,
   B=8, one forward+backward through the kernels against the plain path
   (loss and every gradient; the folded forward #9 and backward #10
   launched once a layer on the kernel run, never on the plain run);
   (b) B=64 under the bf16 recipe with ``AdamW(1e-4)`` and
   ``TrainStep.multi_step``: finite losses, ms a step, tokens/s, MFU
   (the port's copy of ``bench_all.py``'s executed-FLOPs count), peak
   memory, launches a step, a profiled step; then #9 and #10 at that
   shape (B=64 S=512 H=12 D=64, fp32 and bf16) against their plain
   versions, timed beside them and SDPA.
8b. bert_classify — ``BertForSequenceClassification`` in eval, B=8,
   S=512: a padding mask takes the plain math (bitwise under
   ``plain_kernels()``), no mask the folded kernel, its logits within
   ``MODEL_REL_TOL`` of the plain path's and an all-ones mask's.
8c. export — saved programs in ``inference.Predictor``s, under the
   git-ignored ``build/export/`` (removed after): (a) the JAX
   benchmark's config 5 (``bench_all.py:3304-3366``): ResNet-50 fp32
   NCHW (1, 3, 224, 224) with ``optimize=True`` and BERT-base
   (``BertForSequenceClassification``, dropout 0) at S=128 on int32 ids,
   seed-0 weights: logits within ``MODEL_REL_TOL`` of the eager model,
   no kernel launched (as in JAX: S=128 is under the folded crossover,
   NCHW fails the fused gate), and the JAX ``_serve_latency`` keys: p50
   / p99 wall ms with a host fetch over 100 runs, pipelined ms a
   request over 100 and device ms a request over 300 (one synchronise
   at the end of each window), the dispatch floor, and a profiled run's
   device kernel ms; (b) BERT-base at N=1, S=512: 12 ``attention_fwd``
   launches a run of the loaded program, logits within
   ``MODEL_REL_TOL`` of the eager run under ``plain_kernels()``; (c)
   ResNet-50 NHWC at N=1 opted in to the fused bottleneck, saved with
   ``optimize=False``: 5 ``fused_bottleneck`` launches a run, logits
   within ``RESNET_REL_TOL`` of the plain path; (d) a bf16-storage
   predictor against an fp32 one over parameters rounded to bf16
   (``MODEL_REL_TOL``), and a card program under ``disable_gpu()``
   refused.
8d. seq2seq_beam — ``Transformer()`` (Transformer-base), a shared
   vocabulary of 37000, beam 4: 8 sources of 64 tokens,
   ``BeamSearchDecoder`` + ``dynamic_decode`` for at most 64 + 50 steps
   over the decoder with its ``MultiHeadAttention.Cache`` states; each
   best score against a teacher-forced uncached forward under the
   causal mask; ms a step and tokens/s. Its attention is plain math at
   these lengths, as in the JAX package.

Then, if no check failed, the script's wall time, a ``kernels`` line,
the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA GPU and ``nvcc``. It takes no arguments.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
try:
    # the cost counts the engine's program_costs reads too, so the
    # kernel table and the engine count the same work
    from paddle_tpu_torch.inference.costs import (
        BF16_FLOPS, PAGED_POOLS, attention_fwd_cost, bound_ms,
        out_proj_cost, paged_bytes)
except ImportError:
    pass  # the script without the package beside it: main() says so

# tolerances, stated: fp32 sums run in another order in the kernel than
# in the plain version (atol/rtol 1e-4); argmax must be index-exact;
# the whole model's hidden states and logits within 1e-3 relative
ATTN_TOL = 1e-4
PAGED_TOL = 1e-4
PROJ_TOL = 1e-4
BWD_TOL = 1e-4
MODEL_REL_TOL = 1e-3
# training, kernel path against plain path: the loss within 1e-5
# relative, every parameter's gradient within 1e-3 relative in L2 norm
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-3
TRAIN_LR = 1e-4
# bf16 storage (f32 accumulation), absolute: about 2.5x the largest
# error an H100 showed on seeded inputs (paged_decode 7.6e-6,
# decode_out_proj 3.9e-3, attention_fwd 2.0e-3, attention_bwd_fused
# 9.8e-4, folded_attention_bwd 2.0e-3); the outputs are rounded to bf16
# from f32 sums taken in another order. The dQ and dK/dV passes take the
# limit of the folded kernel, which computes the same products on the
# same S=512 inputs. paged_decode's 2e-5 is below one bf16 ulp
# at its outputs' size, so its limit is at least BF16_ULPS ulps of the
# largest plain output (``bf16_limit``); so is fused_bottleneck's, whose
# output is rounded to bf16 once more after the residual
BF16_ULPS = 2
BF16_ATOL = {"paged_decode": 2e-5, "decode_out_proj": 1e-2,
             "attention_fwd": 5e-3,
             "attention_bwd_fused": 2.5e-3, "attention_bwd_dq": 5e-3,
             "attention_bwd_dkv": 5e-3, "folded_attention_bwd": 5e-3}
# The tensor-core kernels' bf16 outputs take their BF16_ATOL before the
# rounding (``check_rounded_from``): each must be the bf16 rounding of a
# value within the limit of the plain version's f32 result. Held after
# the rounding, a limit below one bf16 ulp of the larger outputs passes
# only a sum in the plain version's own order: the exact (f64) result
# rounded to bf16 misses it (tests/test_torch_attention_bwd.py, and
# tests/test_torch_attention_fwd.py for the forward, whose 5e-3 is below
# one ulp at |out| >= 1), and a tensor-core sum has another order. A
# plain emulation of one-term bf16 P (and dS) must fail the check in at
# least one case of each kernel (``bf16_terms_fwd``, ``bf16_terms_bwd``).
BF16_BEFORE_ROUNDING = ("attention_fwd", "attention_bwd_fused",
                        "folded_attention_bwd", "attention_bwd_dq",
                        "attention_bwd_dkv")
# fp16 storage (``auto_cast(dtype="float16")``): the attention kernels'
# limits, taken before the rounding as in bf16, are their BF16_ATOL
# scaled by fp16's unit roundoff over bf16's, 2^-11 / 2^-8: what a
# kernel adds before the output's rounding comes from its sum order and
# from the two-term split of P and dS, each relative to the storage
# type's precision (fp16 keeps 11 significant bits, bf16 8)
FP16_U = 2.0 ** -11
FP16_ATOL = {k: BF16_ATOL[k] * FP16_U / 2.0 ** -8
             for k in BF16_BEFORE_ROUNDING}

# (kernel, source, TPU kernel it replaces)
KERNEL_META = {
    "paged_decode": ("paddle_tpu_torch/csrc/paged_decode.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:227"),
    "decode_out_proj": ("paddle_tpu_torch/csrc/decode_out_proj.cu",
                        "paddle_tpu/ops/pallas/paged_attention.py:287"),
    "fused_argmax": ("paddle_tpu_torch/csrc/fused_argmax.cu",
                     "paddle_tpu/ops/pallas/fused_sample.py:241"),
    "attention_fwd": ("paddle_tpu_torch/csrc/attention_fwd.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:414"),
    "attention_bwd_fused": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:462"),
    "attention_bwd_dq": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                         "paddle_tpu/ops/pallas/flash_attention.py:496"),
    "attention_bwd_dkv": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                          "paddle_tpu/ops/pallas/flash_attention.py:515"),
    "folded_attention_bwd": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                             "paddle_tpu/ops/pallas/folded_attention.py:176"),
    "fused_bottleneck": ("paddle_tpu_torch/csrc/fused_bottleneck.cu",
                         "paddle_tpu/ops/pallas/fused_conv_block.py:143"),
    # the port's own kernel: no TPU kernel; it replaces the JAX Adam
    # rule that XLA fuses into the jitted step
    "adam_update": ("paddle_tpu_torch/csrc/adam_update.cu",
                    "paddle_tpu/optimizer/optimizer.py:420"),
}
# the fp16 instantiations (train_amp's fp16 paths), each a record of its
# own beside the kernel's: "<kernel>_fp16"
FP16_KERNELS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv",
                "attention_bwd_fused", "folded_attention_bwd", "adam_update")
KERNEL_META.update({f"{k}_fp16": KERNEL_META[k] for k in FP16_KERNELS})
# the kernels each main path launches; their counts are read from it
SERVING_KERNELS = ("paged_decode", "decode_out_proj", "fused_argmax",
                   "attention_fwd")
TRAINING_KERNELS = ("attention_bwd_fused", "attention_bwd_dq",
                    "attention_bwd_dkv", "folded_attention_bwd")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


SPIN_CAP_MS = 50.0


class Timer:
    """Median ms of ``fn`` over ``iters`` launches, each bracketed by
    CUDA events, with the L2 cache flushed before every launch (the
    serving path meets each weight cold). The flush reads a 64 MB
    buffer, so the L2 holds clean lines: a flush by writing left 50 MB
    of dirty lines whose write-back landed in the next window (3-5 us
    on a 16.8 MB read). Device time only: after the flush a device-side
    spin (``torch.cuda._sleep``) longer than twice ``fn``'s host time (at
    most ``SPIN_CAP_MS``) is queued before the start event, so the
    launches are queued before the device reaches it and the wrapper's
    checks and allocations stay out of the window."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.ones(16 << 20, dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(1 << 20)
        e.record()
        e.synchronize()
        self.cycles_per_ms = (1 << 20) / max(s.elapsed_time(e), 1e-3)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        host_ms = 0.0
        for _ in range(warmup):
            t0 = time.perf_counter()
            fn()
            host_ms = max(host_ms, (time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        spin = int(self.cycles_per_ms * min(SPIN_CAP_MS,
                                            2.0 * host_ms + 0.05))
        times = []
        for _ in range(iters):
            self.flush.sum()
            torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def check_gen(torch, dev, name: str):
    """The generator of one named check, seeded from its name: each check
    draws its own inputs, so adding or reordering checks changes no other
    check's inputs."""
    return torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))


def bf16_limit(floor: float, want) -> float:
    """``floor``, or ``BF16_ULPS`` bf16 ulps (8 significant bits) of the
    largest magnitude of the plain output ``want``, whichever is
    larger."""
    top = float(want.float().abs().max().item())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return max(floor, BF16_ULPS * ulp)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


# the closeness checks that failed; main exits 1 after the last phase
# if any did
FAILED_CHECKS = []
# each limited check's largest share of its limit (1.0 = at the limit);
# main prints the tightest, so a check that runs close to its limit shows
# in a run that passes
CHECK_SHARES = {}


def note_share(name, share) -> None:
    """Record ``share`` (a check's error over its limit) under ``name``,
    keeping the largest."""
    share = float(share)
    share = math.inf if math.isnan(share) else share
    if share > CHECK_SHARES.get(name, -1.0):
        CHECK_SHARES[name] = share


def tightest_checks(n=15):
    """The ``n`` checks nearest their limits, largest share first."""
    top = sorted(CHECK_SHARES.items(), key=lambda kv: -kv[1])[:n]
    return [{"check": k, "share_of_limit": v} for k, v in top]


def check_close(name, got, want, tol, rtol=None):
    """The max abs error of ``got`` against ``want``; where ``got`` lies
    outside ``tol`` (atol) and ``rtol`` (default ``tol``) the check is
    printed and recorded in ``FAILED_CHECKS``."""
    import torch
    rtol = tol if rtol is None else rtol
    err = max_err(got, want)
    g, w = got.float(), want.float()
    note_share(name, ((g - w).abs() / (tol + rtol * w.abs())).max().item())
    if not torch.allclose(g, w, atol=tol, rtol=rtol):
        FAILED_CHECKS.append(f"{name}: max abs err {err:.3g} over atol "
                             f"{tol} rtol {rtol}")
        emit({"check": name, "ok": False, "max_abs_err": err, "atol": tol,
              "rtol": rtol})
    return err


def rounded_from(got, want32, tol) -> bool:
    """Whether every element of ``got`` (bf16) is the rounding of a value
    within ``tol`` of ``want32``, an f32 result before its rounding: it
    lies between the roundings of ``want32 - tol`` and ``want32 + tol``.
    Where ``want32`` is not within ``tol`` of a rounding midpoint, only
    the plain version's own rounding passes."""
    lo = (want32.double() - tol).to(got.dtype)
    hi = (want32.double() + tol).to(got.dtype)
    return bool(((got >= lo) & (got <= hi)).all().item())


def check_rounded_from(name, got, want32, tol):
    """``check_close`` with ``tol`` taken before the rounding
    (``rounded_from``); returns the max abs error against the rounded
    ``want32``."""
    err = max_err(got, want32.to(got.dtype))
    if not rounded_from(got, want32, tol):
        FAILED_CHECKS.append(f"{name}: not the rounding of a value within "
                             f"{tol} of the plain f32 result (max abs err "
                             f"{err:.3g} after rounding)")
        emit({"check": name, "ok": False, "max_abs_err": err, "atol": tol,
              "before_rounding": True})
    return err


# -- phase 1 -----------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    info = {"phase": "device", "ok": True,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return line


# -- phase 2 -----------------------------------------------------------------

# the backward's tensor-core kernels (csrc/attention_bwd.cu: the single
# pass and the statistics launch of modes 2, 3, the dQ pass of mode 0,
# the dK/dV pass of mode 1): each served instantiation, {fp32, bf16,
# fp16} x {D=64, 128}, must not spill
BWD_TC_KERNELS = ("attention_bwd_fused_kernel", "attention_bwd_stats_kernel",
                  "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")
BWD_DTYPES = ("fp32", "bf16", "fp16")


def _mangled_dtype(mangled: str) -> str:
    """The storage type of a kernel instantiation from its mangled name."""
    if "bfloat16" in mangled:
        return "bf16"
    return "fp16" if "__half" in mangled else "fp32"


def ptxas_usage(text: str):
    """Registers, stack frame and spill bytes of every kernel entry in
    ``ptxas -v`` output, by mangled name."""
    usage = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            hit = re.search(pat, line)
            if hit:
                usage[name][key] = int(hit.group(1))
    return usage


def bwd_ptxas(usage):
    """``ptxas -v``'s registers and spills of the backward's tensor-core
    kernels, keyed ``kernel dtype D``; raises if one is missing or
    spills."""
    rows = {}
    for mangled, u in usage.items():
        kernel = next((k for k in BWD_TC_KERNELS if k in mangled), None)
        if kernel is None:
            continue
        d = re.search(r"Li(\d+)E", mangled).group(1)
        rows[f"{kernel} {_mangled_dtype(mangled)} D={d}"] = u
    want = [f"{k} {dt} D={d}" for k in BWD_TC_KERNELS
            for dt in BWD_DTYPES for d in (64, 128)]
    missing = [w for w in want if w not in rows]
    if missing:
        raise AssertionError(f"ptxas -v shows no lines for {missing}")
    spills = {k: u for k, u in rows.items()
              if u.get("spill_stores", 0) or u.get("spill_loads", 0)}
    if spills:
        raise AssertionError(f"backward kernel spills: {spills}")
    return rows


def fb_ptxas(usage):
    """``ptxas -v``'s registers and spills of the fused bottleneck's two
    instantiations (fp32, bf16); raises if one is missing or spills."""
    rows = {}
    for mangled, u in usage.items():
        if "bottleneck_kernel" in mangled:
            rows["bf16" if "bfloat16" in mangled else "fp32"] = u
    if sorted(rows) != ["bf16", "fp32"]:
        raise AssertionError(f"ptxas -v shows {sorted(rows)} of "
                             f"bottleneck_kernel, not fp32 and bf16")
    spills = {k: u for k, u in rows.items()
              if u.get("spill_stores", 0) or u.get("spill_loads", 0)}
    if spills:
        raise AssertionError(f"fused_bottleneck spills: {spills}")
    return rows


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.monotonic()
    path = _build.build(verbose=True)
    _build.lib()
    seconds = round(time.monotonic() - t0, 3)
    with open(_build.ptxas_report_path()) as f:
        usage = ptxas_usage(f.read())
    emit({"phase": "build", "ok": True, "lib": os.path.relpath(path, HERE),
          "seconds": seconds,
          "bwd_ptxas": bwd_ptxas(usage), "fb_ptxas": fb_ptxas(usage)})


# -- phase 3 -----------------------------------------------------------------

def check_equal(name, got, want):
    """Where ``got`` and ``want`` are not the same bits, the check is
    printed and recorded in ``FAILED_CHECKS``."""
    import torch
    if not torch.equal(got, want):
        err = max_err(got, want)
        FAILED_CHECKS.append(f"{name}: not bitwise equal (max abs err "
                             f"{err:.3g})")
        emit({"check": name, "ok": False, "max_abs_err": err,
              "bitwise": True})


def check_tokens(name, got, want):
    """Greedy token lists (one a request) that must be equal; where they
    are not, the check is printed and recorded in ``FAILED_CHECKS``."""
    if got != want:
        apart = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        agree = _agreement(got, want) if len(got) == len(want) else None
        FAILED_CHECKS.append(f"{name}: requests {apart} differ (token "
                             f"agreement {agree})")
        emit({"check": name, "ok": False, "requests_apart": apart,
              "token_agreement": agree})


# the table shape: the engine's 8 slots at lengths from empty to a full
# 2048-token row, GPT-1.3B's heads
PAGED_SHAPE = dict(B=8, H=16, D=128, page=64, max_pages=32,
                   lens=(0, 1, 37, 64, 100, 700, 1500, 2048))


def paged_cases(split):
    """paged_decode checks beyond the table shape, not timed: (label, H,
    D, page, max_pages, lens). A head dim of 64 at page 16; a 64-page
    (4096-token) table, more splits than the engine's 32-page rows; a
    sequence of exactly one split of ``split`` positions; one a token
    past a split."""
    return (("D=64 page=16", 16, 64, 16, 64, (0, 17, split, 1000)),
            ("64-page table", 16, 128, 64, 64, (4096, 3001, 1, 0)),
            ("one split", 16, 128, 64, 32, (split,)),
            ("one past a split", 16, 128, 64, 32, (split + 1,)))


def _paged_inputs(torch, gen, dev, H, D, page, max_pages, lens):
    """q [B, H, D], fp32 pools of B * max_pages pages and the scratch
    page, a page table that is a random permutation of the pool, and the
    lengths."""
    B = len(lens)
    P = B * max_pages
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    kf = torch.randn((P + 1, page, H, D), generator=gen, device=dev)
    vf = torch.randn((P + 1, page, H, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    return (q, kf, vf, perm.reshape(B, max_pages).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _paged_pools(torch, q, kf, vf, pool):
    """(q, k pages, v pages, k scale, v scale) of one pool type: fp32;
    bf16 pools with a bf16 query; int8 pools (quantize_kv) with an fp32
    query."""
    from paddle_tpu_torch.quantization.quant import quantize_kv
    if pool == "fp32":
        return q, kf, vf, None, None
    if pool == "bf16":
        bf = torch.bfloat16
        return q.to(bf), kf.to(bf), vf.to(bf), None, None
    kq, ks = quantize_kv(kf)
    vq, vs = quantize_kv(vf)
    return q, kq, vq, ks, vs


def _paged_check(torch, name, q, kp, vp, table, lens, ksc, vsc):
    """paged_decode against the plain version and the split emulation:
    fp32 queries within ``PAGED_TOL``; bf16 each sequence within the
    ``bf16_limit`` of its own plain output (absolute), so the long
    sequences, whose contexts are small, are not held to the limit of
    the short ones; len 0 exact zeros, no non-finite value. Returns
    (output, max abs error against the plain version)."""
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_reference, paged_decode,
        paged_decode_split_emulation)
    got = paged_decode(q, kp, vp, table, lens, k_scale=ksc, v_scale=vsc)
    want = paged_attention_reference(q[:, None], kp, vp, table, lens,
                                     k_scale=ksc, v_scale=vsc)[:, 0]
    emu = paged_decode_split_emulation(q, kp, vp, table, lens, k_scale=ksc,
                                       v_scale=vsc)
    torch.cuda.synchronize()
    empty = lens == 0
    if empty.any() and got[empty].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: len 0 must give zeros")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if q.dtype != torch.bfloat16:
        err = check_close(name, got, want, PAGED_TOL)
        check_close(f"{name} vs split emulation", got, emu, PAGED_TOL)
        return got, err
    err = 0.0
    for i in range(q.shape[0]):
        tol = bf16_limit(BF16_ATOL["paged_decode"], want[i])
        err = max(err, check_close(f"{name} row {i}", got[i], want[i], tol,
                                   0.0))
        check_close(f"{name} row {i} vs split emulation", got[i], emu[i],
                    tol, 0.0)
    return got, err


def _paged_invariance(torch, name, got, q, kp, vp, table, lens, ksc, vsc):
    """The batched call twice gives the same bits, and each sequence
    decoded alone with its own table row gives its row's bits."""
    from paddle_tpu_torch.ops.kernels.paged_attention import paged_decode
    check_equal(f"{name} repeat", paged_decode(
        q, kp, vp, table, lens, k_scale=ksc, v_scale=vsc), got)
    for i in range(q.shape[0]):
        alone = paged_decode(q[i:i + 1], kp, vp, table[i:i + 1],
                             lens[i:i + 1], k_scale=ksc, v_scale=vsc)
        check_equal(f"{name} row {i} alone", alone[0], got[i])


def _paged_poisoned(kf, vf, table, lens):
    """Copies of the inputs with NaN where the walk must not read: the
    rows past each length in its last page, and the scratch page, which
    every table entry past a sequence's last page now names."""
    page = kf.shape[1]
    kp, vp, tp = kf.clone(), vf.clone(), table.clone()
    scratch = kf.shape[0] - 1
    kp[scratch] = float("nan")
    vp[scratch] = float("nan")
    for i, n in enumerate(lens.tolist()):
        used = -(-n // page)
        tp[i, used:] = scratch
        if n % page:
            pg = int(tp[i, n // page])
            kp[pg, n % page:] = float("nan")
            vp[pg, n % page:] = float("nan")
    return kp, vp, tp


def kernel_paged(torch, timer, dev, gen, records):
    """paged_decode at the table shape with fp32, bf16 and int8 pools
    against the plain version and the split emulation, batch-invariant
    bit for bit, unchanged by NaN where it must not read; the cases of
    ``paged_cases``; timed per pool beside its bytes bound, with the
    device kernels of one call counted under ``torch.profiler``."""
    from paddle_tpu_torch.ops.kernels import paged_attention as tpa
    paged_attention_reference = tpa.paged_attention_reference
    paged_decode = tpa.paged_decode
    sh = PAGED_SHAPE
    B, H, D, page, max_pages = (sh["B"], sh["H"], sh["D"], sh["page"],
                                sh["max_pages"])
    q32, kf, vf, table, lens = _paged_inputs(torch, gen, dev, H, D, page,
                                             max_pages, sh["lens"])
    errs = {}
    pools = {}
    for pool in PAGED_POOLS:
        args = _paged_pools(torch, q32, kf, vf, pool)
        pools[pool] = args
        name = f"paged_decode {pool}"
        got, errs[pool] = _paged_check(torch, name, *args[:3], table, lens,
                                       *args[3:])
        _paged_invariance(torch, name, got, *args[:3], table, lens,
                          *args[3:])
        if pool == "fp32":
            base = got
        # the engine's decode step with half-prefilled neighbours: every
        # other row masked to the scratch page at length 0. Live rows
        # keep their bits, masked rows give zeros.
        q, kp_, vp_, ksc, vsc = args
        live = torch.arange(B, device=dev) % 2 == 1
        mtable = torch.where(live[:, None], table,
                             torch.full_like(table, kp_.shape[0] - 1))
        mlens = torch.where(live, lens, torch.zeros_like(lens))
        masked = paged_decode(q, kp_, vp_, mtable, mlens, k_scale=ksc,
                              v_scale=vsc)
        check_equal(f"{name} live rows beside masked rows", masked[live],
                    got[live])
        if masked[~live].abs().max().item() != 0.0:
            raise AssertionError(f"{name}: masked rows must give zeros")
    kp, vp, tp = _paged_poisoned(kf, vf, table, lens)
    check_equal("paged_decode fp32 NaN past the length",
                paged_decode(q32, kp, vp, tp, lens), base)
    del kp, vp
    cases = []
    for label, h, d, pg, mp, lens_c in paged_cases(tpa.PAGED_SPLIT_TOKENS):
        cgen = check_gen(torch, dev, f"paged_decode {label}")
        qc, kc, vc, tc, lc = _paged_inputs(torch, cgen, dev, h, d, pg, mp,
                                           lens_c)
        for pool in PAGED_POOLS:
            args = _paged_pools(torch, qc, kc, vc, pool)
            name = f"paged_decode {label} {pool}"
            got, err = _paged_check(torch, name, *args[:3], tc, lc,
                                    *args[3:])
            if pool != "bf16":
                errs[pool] = max(errs[pool], err)
            _paged_invariance(torch, name, got, *args[:3], tc, lc, *args[3:])
            cases.append(name)
    tokens = int(lens.sum().item())
    flops = 4 * tokens * H * D
    rows = {}
    for pool, (q, kp, vp, ksc, vsc) in pools.items():
        ms = timer(lambda: paged_decode(q, kp, vp, table, lens, k_scale=ksc,
                                        v_scale=vsc))
        plain_ms = timer(lambda: paged_attention_reference(
            q[:, None], kp, vp, table, lens, k_scale=ksc, v_scale=vsc))
        b, by = bound_ms(paged_bytes(tokens, B, H, D, max_pages, pool),
                         flops, "bf16" if pool == "bf16" else "fp32")
        prof = profile_once(torch, lambda: paged_decode(
            q, kp, vp, table, lens, k_scale=ksc, v_scale=vsc))
        rows[pool] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                          bound_share=b / ms, max_abs_err=errs[pool],
                          launches_per_call=prof["kernels"],
                          kernels_in_call=[n for n, _ in
                                           prof["top_kernels_ms"]])
    fp32 = rows["fp32"]
    records["paged_decode"] = dict(
        max_abs_err=fp32["max_abs_err"], ms=fp32["ms"],
        plain_ms=fp32["plain_ms"], bound_ms=fp32["bound_ms"],
        bound_by=fp32["bound_by"], library_ms=None,
        shape=f"B={B} H={H} D={D} page={page} lens={lens.tolist()} fp32")
    emit({"phase": "kernels", "kernel": "paged_decode", "ok": True,
          **records["paged_decode"], "tol": PAGED_TOL,
          "launches_per_call": fp32["launches_per_call"],
          "split_tokens_input": tpa.PAGED_SPLIT_TOKENS, "pools": rows,
          "cases": [f"paged_decode {p}" for p in PAGED_POOLS] + cases,
          "checks": "plain version, split emulation, repeat and each row "
                    "alone bitwise, live rows beside rows masked to the "
                    "scratch page at length 0 bitwise, NaN past the "
                    "length bitwise"})


# decode_out_proj: the engine's slot counts (1, 8, 64) and one past a
# chunk of 8 batch rows (9); fp32 ctx with fp32 and bf16 W
OUT_PROJ_BATCHES = (1, 8, 9, 64)
OUT_PROJ_TIMED = (8, 64)
# a 13B GPT's width, past the 4096 rows one cluster covers in one pass,
# at a slot count and at one past a group of 64 rows
OUT_PROJ_WIDE = (5120, (8, 65))


def out_proj_cases(torch, decode_out_proj, decode_out_proj_reference,
                   ctx, w32, bias32, errs):
    """decode_out_proj on ``ctx`` with fp32 and bf16 W, with and without
    bias, twice with the same bits, against its plain version within
    ``PROJ_TOL`` (the plain version up-casts bf16 W to fp32 exactly, and
    ctx is fp32, so both run in f32); the largest error per W dtype into
    ``errs``."""
    B, E = ctx.shape
    for tag, w, bias in (("fp32", w32, bias32),
                         ("bf16 W", w32.to(torch.bfloat16),
                          bias32.to(torch.bfloat16))):
        for bb in (bias, None):
            got = decode_out_proj(ctx, w, bb)
            again = decode_out_proj(ctx, w, bb)
            want = decode_out_proj_reference(ctx, w, bb)
            torch.cuda.synchronize()
            name = (f"decode_out_proj B={B} E={E} {tag} "
                    f"{'bias' if bb is not None else 'no bias'}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two runs differ")
            errs[tag] = max(errs[tag], check_close(name, got, want, PROJ_TOL))


def kernel_out_proj(torch, timer, dev, gen, records):
    """decode_out_proj against its plain version at E=2048 for every B in
    ``OUT_PROJ_BATCHES`` and at ``OUT_PROJ_WIDE`` (``out_proj_cases``);
    timed at E=2048, B=8 (the row) and B=64 beside ``addmm``."""
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        decode_out_proj, decode_out_proj_reference)
    E = 2048
    w32 = torch.randn((E, E), generator=gen, device=dev) * 0.02
    bias32 = torch.randn((E,), generator=gen, device=dev)
    errs = {"fp32": 0.0, "bf16 W": 0.0}
    ctxs = {}
    for B in OUT_PROJ_BATCHES:
        ctxs[B] = torch.randn((B, E), generator=gen, device=dev)
        out_proj_cases(torch, decode_out_proj, decode_out_proj_reference,
                       ctxs[B], w32, bias32, errs)
    wide, wide_batches = OUT_PROJ_WIDE
    wgen = check_gen(torch, dev, f"decode_out_proj E={wide}")
    ww = torch.randn((wide, wide), generator=wgen, device=dev) * 0.02
    wb = torch.randn((wide,), generator=wgen, device=dev)
    for B in wide_batches:
        out_proj_cases(torch, decode_out_proj, decode_out_proj_reference,
                       torch.randn((B, wide), generator=wgen, device=dev),
                       ww, wb, errs)
    del ww
    per_shape = []
    # what one PyTorch call that only reads W takes under this timer
    read_ms = timer(lambda: w32.sum())
    for B in OUT_PROJ_TIMED:
        ctx = ctxs[B]
        ms = timer(lambda: decode_out_proj(ctx, w32, bias32))
        plain_ms = timer(lambda: decode_out_proj_reference(ctx, w32, bias32))
        lib_ms = timer(lambda: torch.addmm(bias32, ctx, w32))
        b, by = bound_ms(*out_proj_cost(B, E, E))
        rec = dict(B=B, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b, bound_by=by, w_sum_ms=read_ms)
        per_shape.append(rec)
        emit({"phase": "kernels", "kernel": "decode_out_proj", "ok": True,
              "shape": f"B={B} E={E} fp32", **rec})
    first = per_shape[0]
    records["decode_out_proj"] = dict(
        max_abs_err=errs["fp32"], ms=first["ms"],
        plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], library_ms=first["library_ms"],
        shape=f"B=8 E={E} fp32", per_shape=per_shape)
    emit({"phase": "kernels", "kernel": "decode_out_proj", "ok": True,
          "max_abs_err": errs["fp32"], "tol": PROJ_TOL,
          "bf16_w_max_abs_err": errs["bf16 W"], "bf16_w_tol": PROJ_TOL,
          "library": "torch.addmm",
          "cases": [f"B={B} E={E}" for B in OUT_PROJ_BATCHES]
          + [f"B={B} E={wide}" for B in wide_batches]})


ARGMAX_VERIFY_ROWS = 40  # 8 slots x (k + 1), k = 4
# rows held index-exact: each side of every configuration's row limit
# (csrc/fused_argmax.cu: 8, 64, 128, 256 rows a pass)
ARGMAX_ROWS = (1, 7, 8, 9, 16, 40, 65, 128, 257)
# rows of the other dtype pairs and of the odd vocab: one a configuration
ARGMAX_CONFIG_ROWS = (7, 40, 128, 257)
ARGMAX_TIMED_ROWS = (1, 8, 40, 128)
# the planted cases: a tie across a vocab-tile boundary of every
# configuration (64- and 128-entry tiles) in the 9th row, a first and a
# later NaN, a -inf weight, a +inf weight ahead of a NaN
ARGMAX_TIE = (12799, 12800)
ARGMAX_TIE_ROW = 8
ARGMAX_NAN = (777, 30000)
ARGMAX_NEG_INF = 4321
ARGMAX_INF_THEN_NAN = (2000, 2100)
ARGMAX_PLANTED_ROWS = (8, 9, 128, 257)  # one a configuration
ARGMAX_D = 2048                  # GPT-1.3B's width
ARGMAX_VOCABS = (50304, 50257)   # the served vocab, and a partial tile
ARGMAX_ODD_SHAPES = ((200, 1000), (202, 999))  # (D, V)


def _argmax_weights(torch, gen, dev, V, D, wdt, vocab_major):
    """A seeded [V, D] weight (or its [D, V] copy) in ``wdt``."""
    w = (torch.randn((V, D), generator=gen, device=dev) * 0.02).to(wdt)
    return w if vocab_major else w.t().contiguous()


def _argmax_plant(torch, w, vocab_major, case, h):
    """A copy of ``w`` with one planted case (``ARGMAX_*``)."""
    w = w.clone()
    row = (lambda v: w[v]) if vocab_major else (lambda v: w[:, v])

    def put(v, d, x):
        if vocab_major:
            w[v, d] = x
        else:
            w[d, v] = x
    if case == "tie":
        t1, t2 = ARGMAX_TIE
        hr = h[ARGMAX_TIE_ROW].float()
        row(t1).copy_((hr / hr.norm() * 5.0).to(w.dtype))
        row(t2).copy_(row(t1))
    elif case == "nan":
        for v in ARGMAX_NAN:
            put(v, 0, float("nan"))
    elif case == "-inf":
        put(ARGMAX_NEG_INF, 0, float("-inf"))
    elif case == "inf_then_nan":
        put(ARGMAX_INF_THEN_NAN[0], 0, float("inf"))
        put(ARGMAX_INF_THEN_NAN[1], 0, float("nan"))
    return w


def _argmax_expect(case, h, has_bias):
    """The planted case's known winners, where the inputs fix them."""
    if case == "tie" and not has_bias:
        return [(ARGMAX_TIE_ROW, ARGMAX_TIE[0])]
    if case == "nan":
        return [(r, ARGMAX_NAN[0]) for r in range(h.shape[0])]
    if case == "inf_then_nan":
        return [(r, ARGMAX_INF_THEN_NAN[1]) for r in range(h.shape[0])]
    if case == "-inf":
        # h[r, 0] < 0 makes the logit +inf: that row's winner
        return [(r, ARGMAX_NEG_INF) for r in range(h.shape[0])
                if float(h[r, 0]) < 0]
    return []


def kernel_argmax(torch, timer, dev, gen, records):
    """``fused_argmax`` index-exact against its plain version (run on the
    fp32 upcasts of bf16 operands: the kernel accumulates exact products
    in f32) at every row count of ``ARGMAX_ROWS`` in fp32 (both layouts,
    with and without bias), at one row count a configuration for the
    bf16 pairs and the odd vocab (a partial last tile), at widths off
    the stage slices (``ARGMAX_ODD_SHAPES``), and on the planted cases;
    then timed at ``ARGMAX_TIMED_ROWS`` and bf16 at 8
    rows, each beside its bound, its plain version and
    ``torch.argmax(h @ W.T)``."""
    from paddle_tpu_torch.ops.kernels.fused_sample import (
        fused_argmax, fused_argmax_reference)
    t0 = time.monotonic()
    D = ARGMAX_D
    f32, bf = torch.float32, torch.bfloat16
    n_checked = 0
    rows_max = max(ARGMAX_ROWS)
    for V in ARGMAX_VOCABS:
        for hdt, wdt in ((f32, f32), (f32, bf), (bf, bf)):
            tag_dt = f"{str(hdt)[6:]}/{str(wdt)[6:]}"
            h_all = torch.randn((rows_max, D), generator=gen,
                                device=dev).to(hdt)
            bias = (torch.randn((V,), generator=gen, device=dev)
                    * 0.1).to(wdt)
            for vm in (True, False):
                w = _argmax_weights(torch, gen, dev, V, D, wdt, vm)
                wf = w.float()
                rows = ARGMAX_ROWS if (V == ARGMAX_VOCABS[0]
                                       and wdt == f32) \
                    else ARGMAX_CONFIG_ROWS
                for R in rows:
                    h = h_all[:R].contiguous()
                    for bb in (None, bias):
                        got = fused_argmax(h, w, bb, transpose_y=vm)
                        want = fused_argmax_reference(
                            h.float(), wf, 0 if vm else 1,
                            bias=None if bb is None else bb.float())
                        n_checked += 1
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"fused_argmax V={V} {tag_dt} vm={vm} "
                                f"R={R} bias={bb is not None}: "
                                f"{got.tolist()} != {want.tolist()}")
                if V == ARGMAX_VOCABS[1]:
                    for case in ("tie", "nan", "-inf", "inf_then_nan"):
                        for R in ARGMAX_PLANTED_ROWS:
                            if case == "tie" and R <= ARGMAX_TIE_ROW:
                                continue
                            h = h_all[:R].contiguous()
                            wp = _argmax_plant(torch, w, vm, case, h)
                            wpf = wp.float()
                            for bb in (None, bias):
                                got = fused_argmax(h, wp, bb,
                                                   transpose_y=vm)
                                want = fused_argmax_reference(
                                    h.float(), wpf, 0 if vm else 1,
                                    bias=None if bb is None
                                    else bb.float())
                                n_checked += 1
                                if not torch.equal(got, want):
                                    raise AssertionError(
                                        f"fused_argmax {case} {tag_dt} "
                                        f"vm={vm} R={R} bias="
                                        f"{bb is not None}: "
                                        f"{got.tolist()} != "
                                        f"{want.tolist()}")
                                for r, v in _argmax_expect(
                                        case, h, bb is not None):
                                    if int(got[r]) != v:
                                        raise AssertionError(
                                            f"fused_argmax {case} "
                                            f"{tag_dt} vm={vm} R={R} "
                                            f"row {r}: {int(got[r])} "
                                            f"!= {v}")
                            del wp, wpf
                del w, wf
    # widths off the stage slices: D=200 ends in a partial slice, D=202
    # leaves the rows 16-byte unaligned (element-wise loads)
    for D_, V_ in ARGMAX_ODD_SHAPES:
        for hdt, wdt in ((f32, f32), (bf, bf)):
            h_all = torch.randn((max(ARGMAX_CONFIG_ROWS), D_), generator=gen,
                                device=dev).to(hdt)
            w = (torch.randn((V_, D_), generator=gen, device=dev)
                 * 0.05).to(wdt)
            for vm in (True, False):
                wl = w if vm else w.t().contiguous()
                for R in ARGMAX_CONFIG_ROWS:
                    h = h_all[:R].contiguous()
                    got = fused_argmax(h, wl, None, transpose_y=vm)
                    want = fused_argmax_reference(h.float(), wl.float(),
                                                  0 if vm else 1)
                    n_checked += 1
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"fused_argmax D={D_} V={V_} {hdt} vm={vm} "
                            f"R={R}: {got.tolist()} != {want.tolist()}")
    torch.cuda.synchronize()
    check_s = time.monotonic() - t0
    V = ARGMAX_VOCABS[0]
    per_shape = {}
    w = torch.randn((V, D), generator=gen, device=dev) * 0.02
    for R, dt in [(R, f32) for R in ARGMAX_TIMED_ROWS] + [(8, bf)]:
        h = torch.randn((R, D), generator=gen, device=dev).to(dt)
        ww = w.to(dt)
        ms = timer(lambda: fused_argmax(h, ww, None, transpose_y=True))
        plain_ms = timer(lambda: fused_argmax_reference(h, ww, 0))
        lib_ms = timer(lambda: torch.argmax(h @ ww.t(), dim=-1))
        size = ww.element_size()
        b, by = bound_ms((V * D + R * D) * size + R * 4, 2 * R * V * D,
                         "bf16" if dt == bf else "fp32")
        key = f"R={R}" + (" bf16" if dt == bf else "")
        per_shape[key] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            library_ms=lib_ms, share_of_bound=b / ms,
            shape=f"R={R} D={D} V={V} [V,D] "
                  + ("bf16/bf16" if dt == bf else "fp32"))
        del ww
    main = per_shape["R=8"]
    records["fused_argmax"] = dict(
        max_abs_err=0.0, **{k: main[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape")}, per_shape=per_shape)
    records["fused_argmax"]["verify_shape"] = dict(
        max_abs_err=0.0, **{k: per_shape[f"R={ARGMAX_VERIFY_ROWS}"][k]
                            for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "shape")})
    emit({"phase": "kernels", "kernel": "fused_argmax", "ok": True,
          "tol": "index-exact", "library": "torch.argmax(h @ W.T)",
          "calls_checked": n_checked, "check_s": check_s,
          "rows": list(ARGMAX_ROWS), "config_rows": list(ARGMAX_CONFIG_ROWS),
          "odd_shapes": [list(x) for x in ARGMAX_ODD_SHAPES],
          "planted": ["tie in row %d across %d|%d" % ((ARGMAX_TIE_ROW,)
                                                      + ARGMAX_TIE), "nan",
                      "-inf", "inf_then_nan"],
          "per_shape": per_shape, "wall_s": time.monotonic() - t0})


# attention_fwd checks beyond the timed causal D=128 sequence lengths:
# (label, B, Sq, Sk, H, D, causal); every head dim the wrapper admits,
# ragged lengths that no tile divides, Sq != Sk
ATTN_CASES = (
    ("D=64 S=512", 2, 512, 512, 16, 64, True),
    ("D=64 S=512 non-causal", 2, 512, 512, 16, 64, False),
    ("D=256 S=512", 1, 512, 512, 8, 256, True),
    ("D=256 S=512 non-causal", 1, 512, 512, 8, 256, False),
    ("D=256 S=200", 1, 200, 200, 8, 256, True),
    ("ragged S=200", 2, 200, 200, 16, 128, True),
    ("ragged S=200 non-causal", 2, 200, 200, 16, 128, False),
    ("Sq=200 Sk=333", 1, 200, 333, 16, 128, True),
    ("Sq=200 Sk=333 non-causal", 1, 200, 333, 16, 128, False),
    ("D=64 S=77", 1, 77, 77, 4, 64, True),
    ("S=2048 non-causal", 1, 2048, 2048, 16, 128, False),
)


def _qkv(torch, gen, dev, B, Sq, Sk, H, D, dtype=None):
    """q, k, v as slices of fused projections (the model's strides)."""
    if Sq == Sk:
        qkv = torch.randn((B, Sq, 3, H, D), generator=gen, device=dev)
        qkv = qkv.to(dtype) if dtype is not None else qkv
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
    kv = torch.randn((B, Sk, 2, H, D), generator=gen, device=dev)
    if dtype is not None:
        q, kv = q.to(dtype), kv.to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


def _attn_check(torch, tag, q, k, v, causal, tol, rtol=None):
    """The kernel against its plain version (out and lse), twice with
    the same bits, and without the lse; returns the largest error. A
    bf16 or fp16 ``out`` takes ``tol`` before its rounding
    (``check_rounded_from`` against the plain version's f32 result,
    ``BF16_BEFORE_ROUNDING``)."""
    from paddle_tpu_torch.ops.kernels.attention import (
        attention_fwd, attention_reference)
    half = q.dtype in (torch.bfloat16, torch.float16)
    want_o, want_l = attention_reference(q, k, v, causal=causal)
    if half:
        want_o, _ = attention_reference(q.float(), k.float(), v.float(),
                                        causal=causal)
    got_o, got_l = attention_fwd(q, k, v, causal=causal)
    again_o, again_l = attention_fwd(q, k, v, causal=causal)
    bare_o, _ = attention_fwd(q, k, v, causal=causal, return_lse=False)
    torch.cuda.synchronize()
    if not (torch.isfinite(got_o).all() and torch.isfinite(got_l).all()):
        raise AssertionError(f"attention_fwd {tag}: non-finite output")
    if not (torch.equal(got_o, again_o) and torch.equal(got_l, again_l)
            and torch.equal(got_o, bare_o)):
        raise AssertionError(f"attention_fwd {tag}: two runs differ")
    name = f"attention_fwd {tag} out"
    if half:
        out_err = check_rounded_from(name, got_o, want_o, tol)
    else:
        out_err = check_close(name, got_o, want_o, tol, rtol)
    return max(out_err, check_close(f"attention_fwd {tag} lse", got_l,
                                    want_l, tol, rtol))


def kernel_attention(torch, timer, dev, gen, records):
    """attention_fwd (tensor cores: 3xTF32 in fp32) against its plain
    version in fp32 within ``ATTN_TOL``: causal D=128 at the serving and
    training path's lengths (timed beside SDPA), then ``ATTN_CASES``;
    every case twice with the same bits. Then bf16 at S=2048 timed
    beside SDPA in bf16 (checked in ``kernels_bf16``)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.attention import (
        attention_fwd, attention_reference)
    B, H, D = 1, 16, 128
    per_shape = []
    errs = []
    for S in (128, 256, 512, 1024, 2048):
        q, k, v = _qkv(torch, gen, dev, B, S, S, H, D)
        errs.append(_attn_check(torch, f"S={S}", q, k, v, True, ATTN_TOL))
        ms = timer(lambda: attention_fwd(q, k, v, causal=True))
        plain_ms = timer(lambda: attention_reference(q, k, v, causal=True),
                         iters=20)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        b, by = bound_ms(*attention_fwd_cost(B, S, H, D, True))
        rec = dict(S=S, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b, bound_by=by)
        per_shape.append(rec)
        emit({"phase": "kernels", "kernel": "attention_fwd", "ok": True,
              "shape": f"B={B} S={S} H={H} D={D} causal fp32", **rec})
    for label, b_, sq, sk, h_, d_, causal in ATTN_CASES:
        g2 = check_gen(torch, dev, f"attention_fwd {label}")
        q, k, v = _qkv(torch, g2, dev, b_, sq, sk, h_, d_)
        errs.append(_attn_check(torch, label, q, k, v, causal, ATTN_TOL))
    # bf16 at the training length, timed beside SDPA in bf16
    g2 = check_gen(torch, dev, "attention_fwd bf16 timing")
    q, k, v = _qkv(torch, g2, dev, B, 2048, 2048, H, D, torch.bfloat16)
    ms = timer(lambda: attention_fwd(q, k, v, causal=True))
    plain_ms = timer(lambda: attention_reference(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    b, by = bound_ms(*attention_fwd_cost(B, 2048, H, D, True, 2), "bf16")
    rec = dict(S=2048, dtype="bf16", ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b, bound_by=by)
    per_shape.append(rec)
    emit({"phase": "kernels", "kernel": "attention_fwd", "ok": True,
          "shape": f"B={B} S=2048 H={H} D={D} causal bf16", **rec})
    last = per_shape[-2]
    records["attention_fwd"] = dict(
        max_abs_err=max(errs), ms=last["ms"], plain_ms=last["plain_ms"],
        bound_ms=last["bound_ms"], bound_by=last["bound_by"],
        library_ms=last["library_ms"],
        shape=f"B={B} S=2048 H={H} D={D} causal fp32",
        per_shape=per_shape)
    emit({"phase": "kernels", "kernel": "attention_fwd", "ok": True,
          "max_abs_err": max(errs), "tol": ATTN_TOL,
          "library": "F.scaled_dot_product_attention",
          "cases": [f"S={s_} causal D=128" for s_ in
                    (128, 256, 512, 1024, 2048)]
          + [c[0] for c in ATTN_CASES]})


# (label, S, D, causal, scale of v) of the bf16 forward checks; H=16,
# B=1. On unit-variance inputs one-term bf16 P lies within 3.6e-3 of the
# plain f32 output before the rounding (CPU draws), inside the 5e-3
# limit; with v four times larger (|out| up to ~12, as a model's values
# can be) it lies beyond it, so that case shows the check telling one
# term from two.
BF16_FWD_CASES = (("S=512", 512, 128, True, 1.0),
                  ("S=2048", 2048, 128, True, 1.0),
                  ("S=512 non-causal", 512, 128, False, 1.0),
                  ("D=64 S=200", 200, 64, True, 1.0),
                  ("D=256 S=512", 512, 256, True, 1.0),
                  ("S=512 v x4", 512, 128, True, 4.0))


def bf16_terms_fwd(torch, terms, q, k, v, causal, dtype=None):
    """The plain forward with P carried as ``terms`` terms of ``dtype``
    (bf16 unless given) into P.V, f32 otherwise (scores, max, row sum
    and the division by it): what a kernel with one- or two-term P
    computes. Returns ``out`` rounded to the inputs' dtype."""
    from paddle_tpu_torch.ops.kernels import attention as A
    dtype = torch.bfloat16 if dtype is None else dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = A._scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    hi = p.to(dtype).float()
    if terms == 2:
        hi = hi + (p - hi).to(dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", hi / den, v.float())
    return out.to(q.dtype)


def kernels_bf16(torch, dev):
    """bf16 storage through every kernel (f32 accumulation) against the
    plain versions on the same bf16 inputs, within ``BF16_ATOL`` (no
    relative term; paged_decode at least ``BF16_ULPS`` ulps of its
    output); argmax index-exact. Each check draws from its own
    generator."""
    from paddle_tpu_torch.ops.kernels.fused_sample import (
        fused_argmax, fused_argmax_reference)
    from paddle_tpu_torch.ops.kernels.attention import attention_reference
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        decode_out_proj, decode_out_proj_reference,
        paged_attention_reference, paged_decode)
    bf = torch.bfloat16
    tol = BF16_ATOL
    errs = {}
    H, D, page, B, mp = 16, 128, 64, 4, 8
    lens = torch.tensor([0, 5, 64, 500], dtype=torch.int32, device=dev)
    table = torch.arange(B * mp, dtype=torch.int32,
                         device=dev).reshape(B, mp)
    gen = check_gen(torch, dev, "bf16 paged_decode")
    kp = torch.randn((B * mp + 1, page, H, D), generator=gen,
                     device=dev).to(bf)
    vp = torch.randn((B * mp + 1, page, H, D), generator=gen,
                     device=dev).to(bf)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(bf)
    want = paged_attention_reference(q[:, None], kp, vp, table, lens)[:, 0]
    limits = {"paged_decode": bf16_limit(tol["paged_decode"], want)}
    errs["paged_decode"] = check_close(
        "paged_decode bf16", paged_decode(q, kp, vp, table, lens), want,
        limits["paged_decode"], 0.0)
    gen = check_gen(torch, dev, "bf16 decode_out_proj")
    ctx = torch.randn((B, 2048), generator=gen, device=dev).to(bf)
    w = (torch.randn((2048, 2048), generator=gen, device=dev)
         * 0.02).to(bf)
    got = decode_out_proj(ctx, w)
    if not torch.equal(got, decode_out_proj(ctx, w)):
        raise AssertionError("decode_out_proj bf16: two runs differ")
    errs["decode_out_proj"] = check_close(
        "decode_out_proj bf16", got, decode_out_proj_reference(ctx, w),
        tol["decode_out_proj"], 0.0)
    gen = check_gen(torch, dev, "bf16 fused_argmax")
    h = torch.randn((B, 2048), generator=gen, device=dev).to(bf)
    wv = (torch.randn((50304, 2048), generator=gen, device=dev)
          * 0.02).to(bf)
    got = fused_argmax(h, wv, None, transpose_y=True)
    want = fused_argmax_reference(h.float(), wv.float(), 0)
    if not torch.equal(got, want):
        raise AssertionError(f"fused_argmax bf16: {got.tolist()} != "
                             f"{want.tolist()}")
    ta = tol["attention_fwd"]
    errs["attention_fwd"] = 0.0
    refused = []
    for label, S, D_, causal, v_scale in BF16_FWD_CASES:
        gen = check_gen(torch, dev, "bf16 attention_fwd" +
                        ("" if label == "S=512" else f" {label}"))
        qq, kk, vv = _qkv(torch, gen, dev, 1, S, S, H, D_, bf)
        vv.mul_(v_scale)  # a power of two: exact in bf16
        errs["attention_fwd"] = max(
            errs["attention_fwd"],
            _attn_check(torch, f"bf16 {label}", qq, kk, vv, causal, ta,
                        0.0))
        want32, _ = attention_reference(qq.float(), kk.float(), vv.float(),
                                        causal=causal)
        if not rounded_from(bf16_terms_fwd(torch, 1, qq, kk, vv, causal),
                            want32, ta):
            refused.append(label)
    if not refused:
        raise AssertionError("attention_fwd: the bf16 check passes one-term "
                             "bf16 P in every case")
    emit({"phase": "kernels_bf16", "ok": True, "atol": dict(tol, **limits),
          "max_abs_err": errs, "fused_argmax": "index-exact",
          "attention_fwd_before_rounding": True,
          "attention_fwd_one_term_refused": refused})


def bf16_apart(got, want):
    """How far two bf16 outputs lie apart: the max abs difference and the
    share of elements that differ."""
    return [max_err(got, want), float((got != want).float().mean().item())]


# (label, kernels, B, S, causal, with an lse cotangent, D); H=16. The
# first three are the training path's shapes (GPT-1.3B at B=2); S=200 is
# ragged (a last tile of 8 rows); S=1024 at D=64 is the widest shape the
# folded gate admits (timed too, with the dQ and dK/dV passes).
BWD_CASES = (
    ("S=2048 causal", ("attention_bwd_dq", "attention_bwd_dkv"), 2, 2048,
     True, False, 128),
    ("S=512 causal", ("attention_bwd_fused",), 2, 512, True, False, 128),
    ("S=256 causal", ("folded_attention_bwd",), 2, 256, True, False, 128),
    ("S=512 non-causal", TRAINING_KERNELS, 1, 512, False, False, 128),
    ("S=512 causal, lse cotangent", ("attention_bwd_fused",
                                     "attention_bwd_dq",
                                     "attention_bwd_dkv"), 1, 512, True,
     True, 128),
    ("S=200 causal", TRAINING_KERNELS, 2, 200, True, False, 128),
    ("S=1024 causal D=64", ("folded_attention_bwd", "attention_bwd_dq",
                            "attention_bwd_dkv"), 2, 1024, True, False, 64),
)
# the rows timed: each kernel at its training-path shape, and the folded,
# dQ and dK/dV kernels at D=64
BWD_TIMED = ("S=2048 causal", "S=512 causal", "S=256 causal",
             "S=1024 causal D=64")
# timed in bf16 too: the dQ and dK/dV passes at the headline step's shape
BWD_TIMED_BF16 = ("S=2048 causal",)
# flops per (query, key) pair and head-dim element: 2 per multiply-add
# of each product the function needs (S = QK^T, dP = dO V^T, then dQ;
# dV and dK; all three)
BWD_FLOPS = {"attention_bwd_dq": 6, "attention_bwd_dkv": 8,
             "attention_bwd_fused": 10, "folded_attention_bwd": 10}
# [B, S, H, D] rows read and written, and f32 [B, S, H] rows read
# (lse, delta), by each function
BWD_ROWS = {"attention_bwd_dq": (4, 1, 2), "attention_bwd_dkv": (4, 2, 2),
            "attention_bwd_fused": (4, 3, 2),
            "folded_attention_bwd": (4, 3, 0)}
# the gradients each function returns
BWD_OUTPUTS = {"attention_bwd_dq": ("dq",), "attention_bwd_dkv": ("dk", "dv"),
               "attention_bwd_fused": ("dq", "dk", "dv"),
               "folded_attention_bwd": ("dq", "dk", "dv")}


def _bwd_inputs(torch, gen, dev, B, S, dtype, causal, with_glse,
                H=16, D=128):
    """q, k, v as slices of one fused [B, S, 3, H, D] projection (the
    model's strides), dO, and the flash entries' lse and delta =
    rowsum(dO*O) - g_lse from the plain forward on the same inputs."""
    from paddle_tpu_torch.ops.kernels.attention import attention_reference
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    out, lse = attention_reference(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1)
    if with_glse:
        delta = delta - torch.randn((B, S, H), generator=gen, device=dev)
    return q, k, v, do, lse, delta.contiguous()


def _bwd_call(name, q, k, v, do, lse, delta, causal):
    """The kernel ``name`` and its plain version on the same inputs, as
    dicts {"dq"/"dk"/"dv": tensor}."""
    from paddle_tpu_torch.ops.kernels import attention as A
    if name == "folded_attention_bwd":
        got = A.folded_attention_bwd(q, k, v, do, causal)
        want = A.folded_bwd_reference(q, k, v, do, causal)
    else:
        want = A.attention_bwd_reference(q, k, v, do, lse, delta, causal)
        got = getattr(A, name)(q, k, v, do, lse, delta, causal)
        if name == "attention_bwd_dq":
            got, want = (got,), want[:1]
        elif name == "attention_bwd_dkv":
            want = want[1:]
    keys = BWD_OUTPUTS[name]
    return dict(zip(keys, got)), dict(zip(keys, want))


def bf16_terms_bwd(torch, name, terms, q, k, v, do, lse, delta, causal,
                   dtype=None):
    """The plain version of ``name`` with P carried as ``terms`` terms
    of ``dtype`` (bf16 unless given) into the products (dS = P (dP -
    delta) scale inherits its error), f32 otherwise: what a kernel with
    one- or two-term P/dS computes. Returns the gradients ``name``
    returns (``BWD_OUTPUTS``), {"dq"/"dk"/"dv": tensor}, in the inputs'
    dtype."""
    from paddle_tpu_torch.ops.kernels import attention as A
    dtype = torch.bfloat16 if dtype is None else dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = A._scores(q, k, causal, scale)
    if name == "folded_attention_bwd":
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
        d = (p * dp).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(s - lse.transpose(1, 2)[..., None])
        d = delta.transpose(1, 2)[..., None]
    hi = p.to(dtype).float()
    if terms == 2:
        hi = hi + (p - hi).to(dtype).float()
    grads = dict(zip(("dq", "dk", "dv"),
                     A._grads_from_p(q, k, v, do, hi, d, scale)))
    return {key: grads[key] for key in BWD_OUTPUTS[name]}


def _sdpa_bwd_ms(torch, timer, q, k, v, do, causal):
    """The library yardstick: the backward of
    ``F.scaled_dot_product_attention`` on the same tensors ([B, H, S, D]
    copies), with the first backend that takes them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2).detach().contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        except RuntimeError:
            continue
        ms = timer(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))
        return ms, backend.name
    raise AssertionError("no SDPA backend ran the yardstick")


def kernel_attention_bwd(torch, timer, dev, records):
    """The four backward kernels against their plain versions in fp32
    (atol/rtol ``BWD_TOL``) and bf16 (``BF16_ATOL``, absolute; before the
    rounding for ``BF16_BEFORE_ROUNDING``, where one-term bf16 P/dS
    (``bf16_terms_bwd``) must fail in some case) on ``BWD_CASES``; each
    run twice must give the same bits (no float atomics). On the bf16
    inputs the fp32 kernel runs too and its outputs, rounded to bf16, are
    held against the plain version's (``bf16_apart``: the part of the
    bf16 error that no choice of bf16 operands inside the kernel removes;
    reported, not checked). Then each
    is timed at its training-path shape (the first three cases, fp32),
    and the folded kernel at D=64 S=1024, with one profiled call's
    launches."""
    errs = {torch.float32: {}, torch.bfloat16: {}}
    apart = {}
    failed = set()
    one_term_refused = {}
    timed = []
    for label, names, B, S, causal, with_glse, D in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = check_gen(torch, dev, f"attention_bwd {label} {dtype}")
            ins = _bwd_inputs(torch, gen, dev, B, S, dtype, causal,
                              with_glse, D=D)
            for name in names:
                got, want = _bwd_call(name, *ins, causal)
                again, _ = _bwd_call(name, *ins, causal)
                if dtype == torch.bfloat16:
                    got32, want32 = _bwd_call(
                        name, *(t.float() for t in ins), causal)
                torch.cuda.synchronize()
                n_failed = len(FAILED_CHECKS)
                for key, g in got.items():
                    tag = f"{name} {label} {dtype} {key}"
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"{tag}: non-finite output")
                    if not torch.equal(g, again[key]):
                        raise AssertionError(f"{tag}: two runs differ")
                    if dtype == torch.float32:
                        e = check_close(tag, g, want[key], BWD_TOL)
                    elif name in BF16_BEFORE_ROUNDING:
                        e = check_rounded_from(tag, g, want32[key],
                                               BF16_ATOL[name])
                    else:
                        e = check_close(tag, g, want[key],
                                        BF16_ATOL[name], 0.0)
                    if dtype == torch.bfloat16:
                        a = apart.setdefault(name, {
                            "kernel": [0.0, 0.0],
                            "fp32_kernel_rounded": [0.0, 0.0]})
                        for part, out in (("kernel", g), (
                                "fp32_kernel_rounded",
                                got32[key].to(dtype))):
                            a[part] = [max(x, y) for x, y in zip(
                                a[part], bf16_apart(out, want[key]))]
                    errs[dtype][name] = max(errs[dtype].get(name, 0.0), e)
                if len(FAILED_CHECKS) > n_failed:
                    failed.add(name)
                if dtype == torch.bfloat16 and name in BF16_BEFORE_ROUNDING:
                    one = bf16_terms_bwd(torch, name, 1, *ins, causal)
                    if not all(rounded_from(one[key], want32[key],
                                            BF16_ATOL[name]) for key in one):
                        one_term_refused.setdefault(name, []).append(label)
                if label in BWD_TIMED and (dtype == torch.float32 or
                                           label in BWD_TIMED_BF16):
                    timed.append((name, label, B, S, causal, ins, dtype))
    for name in TRAINING_KERNELS:
        if name not in one_term_refused:
            raise AssertionError(f"{name}: the bf16 check passes one-term "
                                 f"bf16 P/dS in every case")
    for name, label, B, S, causal, ins, dtype in timed:
        from paddle_tpu_torch.ops.kernels import attention as A
        q, k, v, do, lse, delta = ins
        fn = getattr(A, name)
        if name == "folded_attention_bwd":
            call = lambda: fn(q, k, v, do, causal)  # noqa: E731
            plain_ms = timer(lambda: A.folded_bwd_reference(q, k, v, do,
                                                            causal))
        else:
            call = lambda: fn(q, k, v, do, lse, delta, causal)  # noqa: E731
            plain_ms = timer(lambda: A.attention_bwd_reference(
                q, k, v, do, lse, delta, causal))
        ms = timer(call)
        lib_ms, backend = _sdpa_bwd_ms(torch, timer, q, k, v, do, causal)
        H, D = q.shape[2], q.shape[3]
        pairs = S * (S + 1) // 2 if causal else S * S
        rd, wr, st = BWD_ROWS[name]
        bf16 = dtype == torch.bfloat16
        nbytes = ((rd + wr) * B * S * H * D * q.element_size()
                  + st * B * S * H * 4)
        b, by = bound_ms(nbytes, BWD_FLOPS[name] * B * H * pairs * D,
                         "bf16" if bf16 else "fp32")
        tag = "bf16" if bf16 else "fp32"
        rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                   library_ms=lib_ms,
                   shape=f"B={B} S={S} H={H} D={D} {label} {tag}",
                   per_launch_ms=profile_once(torch, call)["top_kernels_ms"])
        if name in records:  # a second timed shape of the kernel
            records[name].setdefault("per_shape", []).append(rec)
        else:
            records[name] = dict(max_abs_err=errs[torch.float32][name],
                                 **rec)
        emit({"phase": "kernels", "kernel": name, "ok": name not in failed,
              **rec, "max_abs_err": errs[dtype][name],
              "tol": BF16_ATOL[name] if bf16 else BWD_TOL,
              "bf16_max_abs_err": errs[torch.bfloat16][name],
              "bf16_atol": BF16_ATOL[name],
              "bf16_before_rounding": name in BF16_BEFORE_ROUNDING,
              "bf16_one_term_refused": one_term_refused.get(name),
              "bf16_apart": apart[name],
              "library": f"SDPA backward ({backend}), dQ+dK+dV",
              "cases": [c[0] for c in BWD_CASES if name in c[1]]})


# fp16 cases of the backward: (label, kernels, B, S), H=16, D=128,
# causal. The first three are train_amp's shapes (GPT-1.3B at B=2: the
# flash passes at S=2048, the single pass at S=512, the folded kernel at
# S=256) and are timed; S=200 is ragged.
FP16_BWD_CASES = (
    ("S=2048 causal", ("attention_bwd_dq", "attention_bwd_dkv"), 2, 2048),
    ("S=512 causal", ("attention_bwd_fused",), 2, 512),
    ("S=256 causal", ("folded_attention_bwd",), 2, 256),
    ("S=200 causal", TRAINING_KERNELS, 2, 200))
# fp16 forward cases: (label, B, S, D, causal), H=16; the first is the
# headline step's shape and is timed
FP16_FWD_CASES = (("S=2048", 2, 2048, 128, True),
                  ("S=512 non-causal", 1, 512, 128, False),
                  ("D=64 S=200", 1, 200, 64, True))


def kernels_fp16(torch, timer, dev, records):
    """fp16 storage through the attention kernels (fp16 operands, f32
    accumulators) against their plain versions on the same fp16 inputs:
    the outputs within ``FP16_ATOL`` before the rounding, each call twice
    with the same bits; whether one-term fp16 P/dS would pass the same
    check is reported (``one_term_refused``). The forward, the dQ and
    dK/dV passes, the single pass and the folded backward are timed at
    train_amp's shapes beside SDPA in fp16 and beside their fp16 bounds
    (989 TFLOP/s). ``adam_update``'s fp16 variant is held in
    ``kernel_adam``."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import attention as A
    h = torch.float16
    H = 16
    errs, one_term = {}, {}
    for label, B, S, D, causal in FP16_FWD_CASES:
        gen = check_gen(torch, dev, f"fp16 attention_fwd {label}")
        q, k, v = _qkv(torch, gen, dev, B, S, S, H, D, h)
        tol = FP16_ATOL["attention_fwd"]
        errs["attention_fwd"] = max(errs.get("attention_fwd", 0.0),
                                    _attn_check(torch, f"fp16 {label}", q, k,
                                                v, causal, tol, 0.0))
        want32, _ = A.attention_reference(q.float(), k.float(), v.float(),
                                          causal=causal)
        if not rounded_from(bf16_terms_fwd(torch, 1, q, k, v, causal, h),
                            want32, tol):
            one_term.setdefault("attention_fwd", []).append(label)
        if label != FP16_FWD_CASES[0][0]:
            continue
        ms = timer(lambda: A.attention_fwd(q, k, v, causal=causal))
        plain_ms = timer(lambda: A.attention_reference(q, k, v,
                                                       causal=causal))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        b, by = bound_ms(*attention_fwd_cost(B, S, H, D, causal, 2), "fp16")
        records["attention_fwd_fp16"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
            bound_by=by, shape=f"B={B} S={S} H={H} D={D} causal fp16")
    records["attention_fwd_fp16"]["max_abs_err"] = errs["attention_fwd"]
    for label, names, B, S in FP16_BWD_CASES:
        gen = check_gen(torch, dev, f"fp16 attention_bwd {label}")
        ins = _bwd_inputs(torch, gen, dev, B, S, h, True, False)
        for name in names:
            got, _ = _bwd_call(name, *ins, True)
            again, _ = _bwd_call(name, *ins, True)
            _, want32 = _bwd_call(name, *(t.float() for t in ins), True)
            torch.cuda.synchronize()
            tol = FP16_ATOL[name]
            for key, g in got.items():
                tag = f"{name} {label} fp16 {key}"
                if g.dtype != h or not torch.isfinite(g).all():
                    raise AssertionError(f"{tag}: {g.dtype}, or non-finite")
                if not torch.equal(g, again[key]):
                    raise AssertionError(f"{tag}: two runs differ")
                errs[name] = max(errs.get(name, 0.0), check_rounded_from(
                    tag, g, want32[key], tol))
            one = bf16_terms_bwd(torch, name, 1, *ins, True, h)
            if not all(rounded_from(one[key], want32[key], tol)
                       for key in one):
                one_term.setdefault(name, []).append(label)
            if label == FP16_BWD_CASES[-1][0]:
                continue
            q, k, v, do, lse, delta = ins
            fn = getattr(A, name)
            if name == "folded_attention_bwd":
                call = lambda: fn(q, k, v, do, True)  # noqa: E731
                plain_ms = timer(lambda: A.folded_bwd_reference(
                    q, k, v, do, True))
            else:
                call = lambda: fn(q, k, v, do, lse, delta, True)  # noqa
                plain_ms = timer(lambda: A.attention_bwd_reference(
                    q, k, v, do, lse, delta, True))
            ms = timer(call)
            lib_ms, backend = _sdpa_bwd_ms(torch, timer, q, k, v, do, True)
            D = q.shape[3]
            rd, wr, st = BWD_ROWS[name]
            nbytes = (rd + wr) * B * S * H * D * 2 + st * B * S * H * 4
            b, by = bound_ms(nbytes, BWD_FLOPS[name] * B * H *
                             (S * (S + 1) // 2) * D, "fp16")
            records[f"{name}_fp16"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                bound_by=by, library=f"SDPA backward ({backend})",
                shape=f"B={B} S={S} H={H} D={D} causal fp16")
    for name in TRAINING_KERNELS:
        records[f"{name}_fp16"]["max_abs_err"] = errs[name]
    emit({"phase": "kernels_fp16", "ok": True, "atol": FP16_ATOL,
          "before_rounding": True, "max_abs_err": errs,
          "one_term_refused": one_term,
          "records": {n: records[f"{n}_fp16"] for n in
                      ("attention_fwd",) + TRAINING_KERNELS}})


# (label, N, H, W, C, M): the two shapes ResNet-50's main path gives the
# kernel at 224x224 and N=128 (layer1 and layer2), small ones whose tiles
# have masked edges (M=8 C=32, a non-square 6x5 plane), and at N=1 the
# layer2, layer3 and layer4 blocks of a 896x896 input, which the gate
# admits and the first, FMA kernel could not place in 227 KB
FB_CASES = (
    ("layer1 56x56", 128, 56, 56, 256, 64),
    ("layer2 28x28", 128, 28, 28, 512, 128),
    ("M=8 C=32 28x28", 2, 28, 28, 32, 8),
    ("6x5", 2, 6, 5, 32, 8),
    ("896 layer2 112x112", 1, 112, 112, 512, 128),
    ("896 layer3 56x56", 1, 56, 56, 1024, 256),
    ("896 layer4 28x28", 1, 28, 28, 2048, 512),
)
FB_TOL = 1e-4


def _fb_params(torch, gen, dev, c, m, dtype):
    """Packed weights of the Kaiming scale a folded block has, and f32
    biases: ``(w1 [C, M], b1, w2 [9M, M], b2, w3 [M, C], b3)``."""
    def draw(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return (draw((c, m), (2.0 / c) ** 0.5).to(dtype), draw((1, m), 0.1),
            draw((9 * m, m), (2.0 / (9 * m)) ** 0.5).to(dtype),
            draw((1, m), 0.1), draw((m, c), (1.0 / m) ** 0.5).to(dtype),
            draw((1, c), 0.1))


def _fb_chain(torch, w1, b1, w2, b2, w3, b3):
    """The library yardstick: the unfused block on the same folded
    weights, three ``F.conv2d`` (cuDNN, NHWC memory) with the bias, relu
    and residual epilogues, in the weights' dtype. Returns ``fn(x)``."""
    import torch.nn.functional as F
    c, m = w1.shape
    k1 = w1.t().reshape(m, c, 1, 1).contiguous()
    k2 = w2.reshape(3, 3, m, m).permute(3, 2, 0, 1).contiguous()
    k3 = w3.t().reshape(c, m, 1, 1).contiguous()
    bb1, bb2, bb3 = (b[0].to(w1.dtype) for b in (b1, b2, b3))

    def fn(x):
        xc = x.permute(0, 3, 1, 2)
        y1 = torch.relu(F.conv2d(xc, k1, bb1))
        y2 = torch.relu(F.conv2d(y1, k2, bb2, padding=1))
        return torch.relu(F.conv2d(y2, k3, bb3) + xc).permute(0, 2, 3, 1)
    return fn


def _fb_config(torch, FC, dev, n, h, w, c, m, dtype):
    """The kernel's launch configuration for these inputs (the wrapper's
    own choice) and its inputs to the line. The blocks an SM holds by the
    CUDA occupancy API must be the configuration's (the tile choice
    weighs them): fewer raises."""
    cfg = FC.fused_bottleneck_config(
        h, w, c, m, dtype, n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    blocks = FC.fused_bottleneck_occupancy(cfg.smem, dtype)
    if blocks < cfg.blocks_per_sm:
        raise AssertionError(f"fused_bottleneck {h}x{w} M={m} {dtype}: the "
                             f"card holds {blocks} blocks an SM, the tile "
                             f"choice assumed {cfg.blocks_per_sm}")
    return cfg, dict(tile_rows=cfg.tr, tile_cols=cfg.tc, strips=cfg.strips,
                     col_tiles=cfg.col_tiles, smem_bytes=cfg.smem,
                     blocks_per_sm_input=cfg.blocks_per_sm,
                     blocks_per_sm=blocks, halo_share_input=cfg.halo_share)


def kernel_fused_bottleneck(torch, timer, dev, records):
    """The fused bottleneck on ``FB_CASES`` and the delta image of
    ``tests/test_fused_conv_block.py`` (edge columns), against its plain
    version and against the plain emulation of its tiles
    (``fused_bottleneck_strip_emulation``, the same configuration): fp32
    within atol/rtol ``FB_TOL``, twice with the same bits; bf16 within
    ``BF16_ULPS`` ulps of the largest output (absolute). Timed at the two
    ResNet-50 shapes in fp32 and bf16 beside the plain version and the
    unfused cuDNN chain in the same dtype, with its device kernels a call
    counted under ``torch.profiler``."""
    from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
    cases = list(FB_CASES) + [("delta 4x4", 1, 4, 4, 32, 8)]
    errs = {"fp32": 0.0, "bf16": 0.0}
    bf16_limits = {}
    configs = {}
    per_shape = []
    for label, n, h, w, c, m in cases:
        gen = check_gen(torch, dev, f"fused_bottleneck {label}")
        params32 = _fb_params(torch, gen, dev, c, m, torch.float32)
        if label.startswith("delta"):
            x32 = torch.zeros((n, h, w, c), device=dev)
            x32[0, 1, 0] = 1.0
            x32[0, 2, 3] = -1.0
        else:
            x32 = torch.randn((n, h, w, c), generator=gen, device=dev)
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            params = tuple(p.to(dtype) if i % 2 == 0 else p
                           for i, p in enumerate(params32))
            cfg, inputs = _fb_config(torch, FC, dev, n, h, w, c, m, dtype)
            configs[f"{label} {tag}"] = inputs
            got = FC.fused_bottleneck_eval(x, *params)
            want = FC.fused_bottleneck_reference(x, *params)
            tiles = FC.fused_bottleneck_strip_emulation(x, *params,
                                                        config=cfg)
            torch.cuda.synchronize()
            name = f"fused_bottleneck {label} {tag}"
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite output")
            if tag == "fp32":
                e = check_close(name, got, want, FB_TOL)
                check_close(f"{name} vs tile emulation", got, tiles, FB_TOL)
                if not torch.equal(got, FC.fused_bottleneck_eval(x, *params)):
                    raise AssertionError(f"{name}: two runs differ")
            else:
                lim = bf16_limit(0.0, want)
                bf16_limits[label] = lim
                e = check_close(name, got, want, lim, 0.0)
                check_close(f"{name} vs tile emulation", got, tiles,
                            bf16_limit(0.0, tiles), 0.0)
            errs[tag] = max(errs[tag], e)
        if n != RESNET_BATCH:  # only the main path's shapes are timed
            continue
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            params = tuple(p.to(dtype) if i % 2 == 0 else p
                           for i, p in enumerate(params32))
            chain = _fb_chain(torch, *params)
            want = FC.fused_bottleneck_reference(x, *params)
            if tag == "fp32":
                chain_err = check_close(f"cuDNN chain {label}", chain(x),
                                        want, FB_TOL)
            else:  # a yardstick of speed, rounded in its own places
                chain_err = max_err(chain(x), want)
            ms = timer(lambda: FC.fused_bottleneck_eval(x, *params))
            plain_ms = timer(lambda: FC.fused_bottleneck_reference(x, *params))
            lib_ms = timer(lambda: chain(x))
            item = x.element_size()
            nbytes = (2 * x.numel() + 2 * c * m + 9 * m * m) * item \
                + (2 * m + c) * 4
            b, by = bound_ms(nbytes, 2 * n * h * w * (2 * c * m + 9 * m * m),
                             tag)
            prof = profile_once(
                torch, lambda: FC.fused_bottleneck_eval(x, *params),
                (("fused_bottleneck", ("bottleneck_kernel",)),))
            rec = dict(label=label, dtype=tag, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b, bound_by=by,
                       bound_share=b / ms, chain_max_abs_err=chain_err,
                       launches_per_call=prof["kernels"],
                       kernels_in_call=[k for k, _ in prof["top_kernels_ms"]],
                       **configs[f"{label} {tag}"])
            per_shape.append(rec)
            emit({"phase": "kernels", "kernel": "fused_bottleneck", "ok": True,
                  "shape": f"N={n} H={h} W={w} C={c} M={m} {tag}", **rec})
    first = per_shape[0]
    records["fused_bottleneck"] = dict(
        max_abs_err=errs["fp32"], ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=first["library_ms"], shape="N=128 56x56 C=256 M=64 fp32",
        per_shape=per_shape)
    emit({"phase": "kernels", "kernel": "fused_bottleneck", "ok": True,
          "max_abs_err": errs["fp32"], "tol": FB_TOL,
          "bf16_max_abs_err": errs["bf16"], "bf16_atol": bf16_limits,
          "library": "chain of 3 F.conv2d (cuDNN) + bias/relu/residual "
                     "epilogues, not one call",
          "cases": [c[0] for c in cases], "configs": configs,
          "checks": "plain version, tile emulation, fp32 repeat bitwise"})


# GPT-1.3B's parameter shapes of one block (E=2048: ln_1, qkv_proj,
# out_proj, ln_2, fc_in, fc_out, weights and biases; 50.3M elements),
# and a ragged list: a bias, an odd length, an empty tensor, a small
# matrix
ADAM_BLOCK_SHAPES = ((2048,), (2048,), (2048, 6144), (6144,), (2048, 2048),
                     (2048,), (2048,), (2048,), (2048, 8192), (8192,),
                     (8192, 2048), (2048,))
ADAM_RAGGED_SHAPES = ((2048,), (1001,), (0,), (3, 5))
# (label, param dtype, slot dtype): the kernel's four storage variants
ADAM_VARIANTS = (("fp32", "float32", "float32"),
                 ("bf16", "bfloat16", "bfloat16"),
                 ("bf16 params fp32 slots", "bfloat16", "float32"),
                 ("fp16", "float16", "float16"))
ADAM_STEPS = 3
ADAM_LR, ADAM_WD = 1e-4, 0.01


def adam_bytes(n, p_size, s_size):
    """Bytes of one update of ``n`` elements: p, g, m, v read once, p, m,
    v written once (the gradient has the parameter's dtype)."""
    return n * (3 * p_size + 4 * s_size)


def _adam_state(torch, gen, dev, shapes, pdt, sdt):
    """Seeded parameters (N(0, 0.02)), zero moments, and ``ADAM_STEPS``
    gradient lists (N(0, 1e-3))."""
    params = [(torch.randn(s, generator=gen, device=dev) * 0.02).to(pdt)
              for s in shapes]
    grads = [[(torch.randn(s, generator=gen, device=dev) * 1e-3).to(pdt)
              for s in shapes] for _ in range(ADAM_STEPS)]
    m = [torch.zeros(s, dtype=sdt, device=dev) for s in shapes]
    v = [torch.zeros(s, dtype=sdt, device=dev) for s in shapes]
    return params, grads, m, v


def kernel_adam(torch, timer, dev, records):
    """adam_update (the port's own kernel) against its plain version, the
    eager chain, on the card: each storage variant (``ADAM_VARIANTS``) x
    each decay (AdamW's decoupled, Adam's L2, none), on a GPT-1.3B
    block's shapes plus a ragged list, ``ADAM_STEPS`` steps: parameters
    and both moments bitwise equal; the list in one call against one call
    a tensor: bitwise equal, one launch against one a non-empty tensor.
    Then each variant timed on the block's shapes (AdamW) beside the
    plain chain and ``torch.optim.AdamW(foreach=True)`` over the same
    list, with the device kernels of one call under ``torch.profiler``."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import optimizer_update as OU
    if _build.lib().pt_adam_update_max_tensors() != OU.MAX_TENSORS:
        raise AssertionError("adam_update: the wrapper's MAX_TENSORS is not "
                             "the kernel's")
    decays = (("AdamW", OU.DECAY_DECOUPLED), ("Adam L2", OU.DECAY_L2),
              ("no decay", OU.DECAY_NONE))
    shapes = ADAM_BLOCK_SHAPES + ADAM_RAGGED_SHAPES
    live = sum(1 for s in shapes if math.prod(s) > 0)
    checks = []
    for label, pname, sname in ADAM_VARIANTS:
        pdt, sdt = getattr(torch, pname), getattr(torch, sname)
        for dname, decay in decays:
            tag = f"adam_update {label} {dname}"
            gen = check_gen(torch, dev, tag)
            p, grads, m, v = _adam_state(torch, gen, dev, shapes, pdt, sdt)
            lists = {"kernel": (p, m, v),
                     "plain": tuple([t.clone() for t in ts]
                                    for ts in (p, m, v)),
                     "per tensor": tuple([t.clone() for t in ts]
                                         for ts in (p, m, v))}
            launched = {}
            for step in range(1, ADAM_STEPS + 1):
                hyper = dict(lr=ADAM_LR, beta1=0.9, beta2=0.999, eps=1e-8,
                             step=step, weight_decay=ADAM_WD, decay=decay)
                g = grads[step - 1]
                OU.adam_update_reference(*lists["plain"][:1], g,
                                         *lists["plain"][1:], **hyper)
                before = OU.adam_update.launches
                OU.adam_update(lists["kernel"][0], g, *lists["kernel"][1:],
                               **hyper)
                launched["list"] = OU.adam_update.launches - before
                before = OU.adam_update.launches
                for i in range(len(shapes)):
                    pt_, mt, vt = (ts[i] for ts in lists["per tensor"])
                    OU.adam_update([pt_], [g[i]], [mt], [vt], **hyper)
                launched["per tensor"] = OU.adam_update.launches - before
            torch.cuda.synchronize()
            for other in ("plain", "per tensor"):
                for what, got, want in zip(("param", "moment1", "moment2"),
                                           lists["kernel"], lists[other]):
                    for i, (a, b) in enumerate(zip(got, want)):
                        check_equal(f"{tag} {what} {i} vs {other}", a, b)
            if launched != {"list": 1, "per tensor": live}:
                FAILED_CHECKS.append(f"{tag}: launches {launched}, want 1 "
                                     f"for the list and {live} one by one")
            checks.append(tag)
    # more tensors than one launch's table: two launches, same bits
    tag = "adam_update fp32 AdamW, MAX_TENSORS + 88 tensors"
    gen = check_gen(torch, dev, tag)
    many = [(1 + (37 * i) % 301,) for i in range(OU.MAX_TENSORS + 88)]
    p, grads, m, v = _adam_state(torch, gen, dev, many, torch.float32,
                                 torch.float32)
    ref = [[t.clone() for t in ts] for ts in (p, m, v)]
    hyper = dict(lr=ADAM_LR, beta1=0.9, beta2=0.999, eps=1e-8, step=1,
                 weight_decay=ADAM_WD, decay=OU.DECAY_DECOUPLED)
    before = OU.adam_update.launches
    OU.adam_update(p, grads[0], m, v, **hyper)
    if OU.adam_update.launches - before != 2:
        FAILED_CHECKS.append(f"{tag}: {OU.adam_update.launches - before} "
                             f"launches, want 2")
    OU.adam_update_reference(ref[0], grads[0], ref[1], ref[2], **hyper)
    for what, got, want in zip(("param", "moment1", "moment2"), (p, m, v),
                               ref):
        check_equal(f"{tag} {what}", torch.cat(got), torch.cat(want))
    checks.append(tag)
    del p, grads, m, v, ref
    per_variant = []
    n = sum(math.prod(s) for s in ADAM_BLOCK_SHAPES)
    # the profiler's name for the device spin that brackets each window
    spin_names = set()
    for _ in range(3):
        spin_names = set(profile_once(
            torch, lambda: torch.cuda._sleep(1000))["kernel_names"])
        if spin_names:
            break
    for label, pname, sname in ADAM_VARIANTS:
        pdt, sdt = getattr(torch, pname), getattr(torch, sname)
        gen = check_gen(torch, dev, f"adam_update timing {label}")
        p, grads, m, v = _adam_state(torch, gen, dev, ADAM_BLOCK_SHAPES,
                                     pdt, sdt)
        g = grads[0]
        hyper = dict(lr=ADAM_LR, beta1=0.9, beta2=0.999, eps=1e-8, step=1,
                     weight_decay=ADAM_WD, decay=OU.DECAY_DECOUPLED)
        ms = timer(lambda: OU.adam_update(p, g, m, v, **hyper))
        plain_ms = timer(lambda: OU.adam_update_reference(p, g, m, v,
                                                          **hyper))
        lib_ms = None
        if pdt == sdt:  # torch.optim keeps the moments in the param dtype
            lp = [t.clone().requires_grad_() for t in p]
            for t, gt in zip(lp, g):
                t.grad = gt.clone()
            opt = torch.optim.AdamW(lp, lr=ADAM_LR, weight_decay=ADAM_WD,
                                    foreach=True)
            lib_ms = timer(opt.step)
            del lp, opt
        calls = 3

        def three():
            # device spins bracket the calls, so a record the profiler
            # drops at a window's edge is a spin's
            for _ in range(2):
                torch.cuda._sleep(1000)
            for _ in range(calls):
                OU.adam_update(p, g, m, v, **hyper)
            for _ in range(2):
                torch.cuda._sleep(1000)

        # the profiler has dropped records inside a window (a whole
        # one-call window once, one of three launches another time): a
        # window that shows fewer adam launches than calls is taken
        # again, at most 3 times; more launches, or any other kernel,
        # fail at once
        for windows in (1, 2, 3):
            prof = profile_once(torch, three)
            adam = prof["kernel_counts"].get("adam_update_kernel", 0)
            other = [n for n in prof["kernel_names"]
                     if "adam_update_kernel" not in n
                     and n not in spin_names and "spin" not in n]
            if adam >= calls or other:
                break
        if adam != calls or other:
            FAILED_CHECKS.append(f"adam_update {label}: {adam} adam "
                                 f"launches in {calls} calls, other "
                                 f"kernels {other}")
        b, by = bound_ms(adam_bytes(n, p[0].element_size(),
                                    m[0].element_size()), 0.0)
        per_variant.append(dict(variant=label, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b, bound_by=by,
                                launches_per_call=adam / calls,
                                profile_windows=windows))
        emit({"phase": "kernels", "kernel": "adam_update", "ok": True,
              "shape": f"GPT-1.3B block, {len(ADAM_BLOCK_SHAPES)} tensors, "
                       f"{n} elements, {label}", **per_variant[-1]})
        del p, grads, m, v, g
    first = per_variant[0]
    records["adam_update"] = dict(
        max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=first["library_ms"], per_variant=per_variant)
    fp16 = next(r for r in per_variant if r["variant"] == "fp16")
    records["adam_update_fp16"] = dict(
        max_abs_err=0.0, **{k: fp16[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=f"GPT-1.3B block, {n} elements, fp16 params and slots")
    emit({"phase": "kernels", "kernel": "adam_update", "ok": True,
          "checks": checks, "steps": ADAM_STEPS, "bitwise": True,
          "max_tensors_a_launch": OU.MAX_TENSORS,
          "library": "torch.optim.AdamW(foreach=True)"})


def phase_kernels(torch, dev, records):
    timer = Timer(torch, dev)
    # the window's own floor: one launch that does almost nothing
    tiny = torch.zeros(1, device=dev)
    emit({"phase": "timer", "ok": True, "flush": "read 64 MB",
          "spin_cycles_per_ms": timer.cycles_per_ms,
          "one_element_add_ms": timer(lambda: tiny.add_(1.0))})
    for fn in (kernel_paged, kernel_out_proj, kernel_argmax,
               kernel_attention):
        fn(torch, timer, dev, check_gen(torch, dev, fn.__name__), records)
    kernels_bf16(torch, dev)
    kernel_attention_bwd(torch, timer, dev, records)
    kernels_fp16(torch, timer, dev, records)
    kernel_fused_bottleneck(torch, timer, dev, records)
    kernel_adam(torch, timer, dev, records)
    torch.cuda.synchronize()


# -- phase 4 -----------------------------------------------------------------

def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item()
                 / max(b.float().abs().max().item(), 1e-30))


def path_outputs(torch, model, prompt, plain: bool, first_token=None,
                 fused: bool = True, quantized: bool = False):
    """Prefill ``prompt`` into a fresh paged cache and decode one token,
    through the kernels or (``plain``) their plain versions, as the
    engine does with ``fused_step=fused`` and ``kv_int8=quantized``.
    Returns (prefill hidden, last-row logits, first token, decode
    hidden, decode logits)."""
    from paddle_tpu_torch.models.gpt import paged_cache_create
    from paddle_tpu_torch.nn.decode import fused_sample_token, sample_token
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    cfg = model.config
    dev = model.device
    page = 64
    mp = -(-cfg.max_seq_len // page)
    n = len(prompt)
    caches = [paged_cache_create(1, mp, page, cfg.num_heads, cfg.head_dim,
                                 torch.float32, mp, quantized=quantized,
                                 device=dev)
              for _ in range(cfg.num_layers)]
    ids = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
    plen = torch.tensor([n], dtype=torch.int32, device=dev)
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    w, ty, bias = model.head_params()
    with ctx, torch.no_grad():
        hidden, caches = model.decode_hidden(ids, caches, prefill_lens=plen,
                                             fused=fused)
        last = hidden[:, n - 1].contiguous()
        logits = model.logits(last)
        if fused:
            tok = fused_sample_token(last, w, 0.0, transpose_y=ty,
                                     bias=bias)
        else:
            tok = sample_token(logits, 0.0)
        if first_token is not None:
            tok = first_token
        h2, _ = model.decode_hidden(tok[:, None].long(), caches,
                                    fused=fused)
        last2 = h2[:, -1].contiguous()
        logits2 = model.logits(last2)
    return hidden[:, :n], logits, tok, last2, logits2


def run_engine(torch, model, prompts, max_new, plain: bool,
               **engine_kw):
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    eng = create_decode_engine(model, device=model.device, num_slots=8,
                               page_size=64, num_pages=96, **engine_kw)
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx:
        rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    eng.check_no_leak()
    outs = [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]
    decode_ms = sorted(e["decode_ms"] for e in eng.step_timeline()
                       if "decode_ms" in e)
    info = {"wall_s": wall, "steps": eng.steps,
            "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
            "prefill_launches": eng.programs_launched.get("prefill", 0),
            "tokens_per_s": sum(len(o) for o in outs) / wall}
    eng.close()
    return outs, info


def profile_decode_steps(torch, model):
    """Device time vs host time of steady decode steps at 8 slots
    (torch.profiler; the eager launch overhead of this slice)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import create_decode_engine
    eng = create_decode_engine(model, device=model.device, num_slots=8,
                               page_size=64)
    gen = torch.Generator().manual_seed(1)
    for n in (300, 500, 700, 900, 1100, 1300, 1500, 1700):
        eng.submit(torch.randint(0, model.config.vocab_size, (n,),
                                 generator=gen).numpy(), max_new_tokens=40)
    for _ in range(6):  # admissions + warm decode steps
        eng.step()
    torch.cuda.synchronize()
    steps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / steps
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    paged_us = sum(e.time_range.elapsed_us() for e in kernels
                   if "paged_decode" in e.name)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    eng.close()
    return {"decode_step_wall_ms": wall_ms,
            "device_kernel_ms_per_step": dev_us / 1e3 / steps,
            "device_kernels_per_step": len(kernels) / steps,
            "paged_decode_ms_per_step": paged_us / 1e3 / steps,
            "idle_share": (1.0 - (dev_us / 1e3 / steps) / wall_ms)
            if wall_ms else None,
            "top_kernels_ms_per_step": [
                [name[:60], us / 1e3 / steps] for name, us in top]}


ENGINE_NEW = 32  # new tokens a request on the engine phase's main path


def phase_engine(torch, dev, records, launches):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    t0 = time.monotonic()
    model = GPTForCausalLM(gpt_1p3b(), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
    model.eval()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(0)

    # kernel path vs plain path on the card: prefill buckets reaching
    # folded (128), flash single-block (512) and flash streaming (1024)
    parity = []
    for n in (128, 512, 1024):
        prompt = torch.randint(0, V, (n,), generator=gen).tolist()
        hk, lk, tk, h2k, l2k = path_outputs(torch, model, prompt, False)
        hp, lp, tp, h2p, l2p = path_outputs(torch, model, prompt, True,
                                            first_token=tk)
        rec = {"bucket": n, "prefill_hidden_rel": rel_err(hk, hp),
               "prefill_logits_rel": rel_err(lk, lp),
               "decode_hidden_rel": rel_err(h2k, h2p),
               "decode_logits_rel": rel_err(l2k, l2p),
               "first_token_equal": bool(torch.equal(tk, tp))}
        parity.append(rec)
        for key in ("prefill_hidden_rel", "prefill_logits_rel",
                    "decode_hidden_rel", "decode_logits_rel"):
            if not rec[key] <= MODEL_REL_TOL:
                raise AssertionError(f"engine parity bucket {n}: {key} "
                                     f"{rec[key]:.3g} > {MODEL_REL_TOL}")
    emit({"phase": "engine_parity", "ok": True, "tol_rel": MODEL_REL_TOL,
          "cases": parity})

    # the main path: every prefill bucket, page recycling (96 pages:
    # the 8th request waits for pages freed by the first seven)
    lengths = (40, 100, 200, 400, 900, 1500, 2000, 600)
    prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
               for n in lengths]
    max_new = ENGINE_NEW
    reset_launch_counts()
    outs, info = run_engine(torch, model, prompts, max_new, plain=False)
    counts = launch_counts()
    launches.update({name: counts[name] for name in SERVING_KERNELS})
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")
    for name in TRAINING_KERNELS + ("fused_bottleneck",):
        if counts[name] != 0:
            raise AssertionError(f"kernel {name} launched {counts[name]} "
                                 f"times while serving")
    for o in outs:
        if len(o) != max_new or not all(0 <= t < V for t in o):
            raise AssertionError(f"bad generation {o[:8]}...")
    outs_plain, info_plain = run_engine(torch, model, prompts, max_new,
                                        plain=True)
    agree = sum(a == b for oa, ob in zip(outs, outs_plain)
                for a, b in zip(oa, ob)) / float(len(lengths) * max_new)
    first_agree = sum(oa[0] == ob[0] for oa, ob in
                      zip(outs, outs_plain)) / float(len(lengths))
    prof = profile_decode_steps(torch, model)
    emit({"phase": "engine", "ok": True, "model": "gpt_1p3b",
          "model_build_s": build_s, "prompt_lengths": list(lengths),
          "max_new_tokens": max_new, "launches": dict(launches),
          "kernel_path": info, "plain_path": info_plain,
          "token_agreement": agree, "first_token_agreement": first_agree,
          "decode_profile": prof,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    engine_variants(torch, model, gen)
    engine_wide(torch, model, gen)
    return model, prompts


# the engine above 8 slots: 32 slots, 32 prompts of 64-512 tokens, 32
# new tokens each, on a pool that admits all 32 at once (page 64: at most
# 9 pages a request, 7.6 GB of fp32 KV at GPT-1.3B)
WIDE_SLOTS = 32
WIDE_NEW = 32
WIDE_LENGTHS = (64, 512)
WIDE_PAGES = 300
WIDE_PROFILE_STEPS = 8


def _unfused_head(hidden_or_logits, hp):
    """The engine's ``_sample`` with the lm head unfused: the logits
    matmul, then argmax over them."""
    from paddle_tpu_torch.nn.decode import _head_logits, sample_token
    if hp is None:
        return sample_token(hidden_or_logits, 0.0)
    w, ty, bias = hp
    return sample_token(_head_logits(hidden_or_logits, w, bias, ty), 0.0)


def engine_wide(torch, model, gen):
    """The engine at ``WIDE_SLOTS`` slots with the fused head, against the
    same run with the head unfused (``_unfused_head``): every greedy
    token bitwise equal; all requests decoding at once; ``fused_argmax``
    launched at 32 rows. Then a profile of ``WIDE_PROFILE_STEPS`` steady
    decode steps: the head kernel's device ms a step beside the step's."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.ops import nn_functional
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    V = model.config.vocab_size
    lengths = torch.randint(WIDE_LENGTHS[0], WIDE_LENGTHS[1] + 1,
                            (WIDE_SLOTS,), generator=gen).tolist()
    prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
               for n in lengths]

    def engine():
        return create_decode_engine(model, device=model.device,
                                    num_slots=WIDE_SLOTS, page_size=64,
                                    num_pages=WIDE_PAGES)

    def run(unfused):
        eng = engine()
        if unfused:
            eng._sample = _unfused_head
        rids = [eng.submit(p, max_new_tokens=WIDE_NEW) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        eng.check_no_leak()
        outs = [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]
        decoding = max(e["slots_decoding"] for e in eng.step_timeline())
        info = {"wall_s": wall, "steps": eng.steps,
                "max_slots_decoding": decoding,
                "tokens_per_s": sum(len(o) for o in outs) / wall}
        eng.close()
        _free_engine_memory(torch)
        return outs, info

    rows = []
    kernel = nn_functional.fused_argmax

    def counted(hidden, *args, **kw):
        rows.append(int(hidden.shape[0]))
        return kernel(hidden, *args, **kw)

    reset_launch_counts()
    nn_functional.fused_argmax = counted
    try:
        outs, info = run(False)
    finally:
        nn_functional.fused_argmax = kernel
    counts = launch_counts()
    _generation_ok("engine_wide", outs, WIDE_NEW, V)
    if info["max_slots_decoding"] != WIDE_SLOTS:
        raise AssertionError(f"engine_wide: {info['max_slots_decoding']} "
                             f"slots decoding at most, not {WIDE_SLOTS}")
    if WIDE_SLOTS not in rows or counts["fused_argmax"] != len(rows):
        raise AssertionError(f"engine_wide: fused_argmax rows {rows}, "
                             f"{counts['fused_argmax']} launches")
    outs_u, info_u = run(True)
    if outs != outs_u:
        bad = [i for i, (a, b) in enumerate(zip(outs, outs_u)) if a != b]
        raise AssertionError(f"engine_wide: fused head tokens differ from "
                             f"the unfused head's in requests {bad}")

    # steady decode steps, every slot decoding
    eng = engine()
    for p in prompts:
        eng.submit(p, max_new_tokens=WIDE_NEW)
    for _ in range(3):  # the admissions + warm decode steps
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(WIDE_PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / WIDE_PROFILE_STEPS
    live = eng.step_timeline()[-1]["slots_decoding"]
    eng.close()
    _free_engine_memory(torch)
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    head_us = sum(e.time_range.elapsed_us() for e in kernels
                  if "argmax_tiles_kernel" in e.name
                  or "argmax_reduce_kernel" in e.name)
    if head_us <= 0:
        raise AssertionError("engine_wide: the profile shows no "
                             "fused_argmax kernel")
    emit({"phase": "engine_wide", "ok": True, "model": "gpt_1p3b",
          "slots": WIDE_SLOTS, "prompt_lengths": lengths,
          "max_new_tokens": WIDE_NEW, "num_pages": WIDE_PAGES,
          "fused": info, "unfused_head": info_u,
          "tokens_bitwise_unfused_head": True,
          "fused_argmax_launches": counts["fused_argmax"],
          "fused_argmax_rows": sorted(set(rows)),
          "profile": {"steps": WIDE_PROFILE_STEPS,
                      "slots_decoding": live,
                      "step_wall_ms": wall_ms,
                      "device_ms_per_step": dev_us / 1e3
                      / WIDE_PROFILE_STEPS,
                      "head_ms_per_step": head_us / 1e3
                      / WIDE_PROFILE_STEPS}})


def engine_variants(torch, model, gen):
    """The engine's two other kernel paths, each against its plain run
    on the card: ``fused_step=False`` (unfused paged attention, the
    out-projection as a GEMM, argmax over the logits; the fused
    kernels must stay at 0 launches) and ``kv_int8`` (int8 pages
    through the fused path)."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    V = model.config.vocab_size
    variants = (
        ("fused_step=False", dict(fused_step=False),
         ("paged_decode", "attention_fwd"),
         ("decode_out_proj", "fused_argmax")),
        ("kv_int8", dict(kv_int8=True), SERVING_KERNELS, ()),
    )
    max_new = 8
    for tag, kw, used, unused in variants:
        fused = kw.get("fused_step", True)
        int8 = kw.get("kv_int8", False)
        prompt = torch.randint(0, V, (512,), generator=gen).tolist()
        hk, lk, tk, h2k, l2k = path_outputs(torch, model, prompt, False,
                                            fused=fused, quantized=int8)
        hp, lp, tp, h2p, l2p = path_outputs(torch, model, prompt, True,
                                            first_token=tk, fused=fused,
                                            quantized=int8)
        rec = {"prefill_hidden_rel": rel_err(hk, hp),
               "prefill_logits_rel": rel_err(lk, lp),
               "decode_hidden_rel": rel_err(h2k, h2p),
               "decode_logits_rel": rel_err(l2k, l2p)}
        for key, val in rec.items():
            if not val <= MODEL_REL_TOL:
                raise AssertionError(f"{tag} parity: {key} {val:.3g} > "
                                     f"{MODEL_REL_TOL}")
        prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
                   for n in (100, 600, 1100)]
        reset_launch_counts()
        outs, info = run_engine(torch, model, prompts, max_new,
                                plain=False, **kw)
        counts = launch_counts()
        for name in used:
            if counts[name] <= 0:
                raise AssertionError(f"{tag}: kernel {name} was not "
                                     f"launched")
        for name in unused:
            if counts[name] != 0:
                raise AssertionError(f"{tag}: kernel {name} launched "
                                     f"{counts[name]} times off its path")
        for o in outs:
            if len(o) != max_new or not all(0 <= t < V for t in o):
                raise AssertionError(f"{tag}: bad generation {o}")
        outs_plain, _ = run_engine(torch, model, prompts, max_new,
                                   plain=True, **kw)
        agree = sum(a == b for oa, ob in zip(outs, outs_plain)
                    for a, b in zip(oa, ob)) / float(len(prompts) * max_new)
        emit({"phase": "engine_variant", "ok": True, "variant": tag,
              "tol_rel": MODEL_REL_TOL, "parity_bucket": 512, **rec,
              "first_token_equal": bool(torch.equal(tk, tp)),
              "prompt_lengths": [len(p) for p in prompts],
              "launches": counts, "token_agreement": agree,
              "decode_step_ms_median": info["decode_step_ms_median"]})


# -- phase 5 -----------------------------------------------------------------

def phase_server(torch, dev, model):
    from paddle_tpu_torch.serving.server import ServingServer, client_request
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(2)
    server = ServingServer(model, device=dev, num_slots=8, page_size=64,
                           num_pages=96)
    port = server.start()
    replies = [None] * 4
    streamed = [[] for _ in range(4)]
    lengths = (50, 300, 700, 1200)

    def one(i):
        prompt = torch.randint(0, V, (lengths[i],), generator=gen).tolist()
        replies[i] = client_request(
            "127.0.0.1", port,
            {"op": "generate", "prompt": prompt, "max_new_tokens": 16,
             "stream": i < 2}, timeout_s=300,
            on_token=streamed[i].append)

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i, r in enumerate(replies):
            if not r or not r.get("done") or len(r["generated"]) != 16:
                raise AssertionError(f"generate {i}: {r}")
            if i < 2 and streamed[i] != r["generated"]:
                raise AssertionError(f"stream {i} != reply")
        health = client_request("127.0.0.1", port, {"op": "health"})
        stats = client_request("127.0.0.1", port, {"op": "stats"})
        drain = client_request("127.0.0.1", port, {"op": "drain"})
        late = client_request("127.0.0.1", port,
                              {"op": "generate", "prompt": [1, 2, 3]})
        leak = client_request("127.0.0.1", port, {"op": "leak_check"})
        if health.get("status") != "ok" or "stats" not in stats or \
                not drain.get("ok") or \
                late.get("error") != "ServerDraining" or \
                not leak.get("ok"):
            raise AssertionError(f"server ops: {health} {drain} {late} "
                                 f"{leak}")
        emit({"phase": "server", "ok": True,
              "ttft_ms": [r["stats"].get("ttft_s", 0) * 1e3
                          for r in replies],
              "tokens_out": [len(r["generated"]) for r in replies],
              "health": {k: health[k] for k in ("status", "free_pages",
                                                "num_pages", "steps")},
              "leak_check": leak.get("ok")})
    finally:
        server.stop()


# -- phase 5b-5d: the prefix cache and crash-safe serving --------------------

PREFIX_PAGE = 64
PREFIX_SYSTEM = 1024  # 16 full pages at page 64
PREFIX_TAILS = (40, 90, 150, 220, 300, 380, 460, 540)
PREFIX_NEW = 32


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def chained_logits(torch, model, prefix, tail, plain: bool):
    """Last-row logits of ``prefix`` prefilled fresh into a paged cache
    and then ``tail`` prefilled chained on top of it (the engine's
    prefix-hit admission), through the kernels or their plain versions;
    and the last-row logits of a fresh prefill of ``prefix + tail``."""
    from paddle_tpu_torch.models.gpt import paged_cache_create
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    cfg = model.config
    dev = model.device
    mp = -(-cfg.max_seq_len // PREFIX_PAGE)

    def caches():
        return [paged_cache_create(1, mp, PREFIX_PAGE, cfg.num_heads,
                                   cfg.head_dim, torch.float32, mp,
                                   device=dev)
                for _ in range(cfg.num_layers)]

    def ids(toks):
        return torch.tensor(toks, dtype=torch.int64, device=dev)[None]

    def lens(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)

    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx, torch.no_grad():
        _, cs = model.decode_hidden(ids(prefix), caches(),
                                    prefill_lens=lens(len(prefix)),
                                    fused=True)
        h, _ = model.decode_hidden(ids(tail), cs,
                                   prefill_lens=lens(len(tail)),
                                   prefill_chained=True, fused=True)
        chained = model.logits(h[:, len(tail) - 1].contiguous())
        whole = prefix + tail
        h2, _ = model.decode_hidden(ids(whole), caches(),
                                    prefill_lens=lens(len(whole)),
                                    fused=True)
        fresh = model.logits(h2[:, len(whole) - 1].contiguous())
    return chained, fresh


def run_cached_engine(torch, model, prompts, max_new, plain: bool,
                      cache, num_slots=8, num_pages=96):
    """All ``prompts`` through one engine with ``cache`` (a PrefixCache
    or None): generated tokens, per-request stats and run info. The
    engine's ``run`` audits the cache (``check_consistent``); ``close``
    then asserts ``check_no_leak``."""
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    done = {}
    eng = create_decode_engine(model, device=model.device,
                               num_slots=num_slots, page_size=PREFIX_PAGE,
                               num_pages=num_pages, prefix_cache=cache,
                               on_complete=lambda r: done.__setitem__(
                                   r.req_id, r))
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx:
        rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    outs = [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]
    stats = [done[r].stats for r in rids]
    cached = cache.total_pages() if cache is not None else None
    decode_ms = sorted(e["decode_ms"] for e in eng.step_timeline()
                       if "decode_ms" in e)
    ttft = [s.ttft_s * 1e3 for s in stats]
    info = {"wall_s": wall, "steps": eng.steps,
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
            "prefill_ms": [s.prefill_ms for s in stats],
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p99": _pct(ttft, 0.99),
            "cached_pages": [s.cached_pages for s in stats],
            "cache_pages_after_run": cached,
            "programs_launched": dict(eng.programs_launched)}
    eng.close()
    return outs, stats, info


def _agreement(a, b):
    n = sum(len(x) for x in a)
    return sum(p == q for x, y in zip(a, b) for p, q in zip(x, y)) / n


def _free_engine_memory(torch):
    # engines with a prefix cache hold a reference cycle (the cache's
    # device IO is bound to the engine): collect them before the next
    # engine allocates its pools
    gc.collect()
    torch.cuda.empty_cache()


def serving_launch_gate(phase, counts, need=SERVING_KERNELS):
    """A serving window's launch counts: each kernel of ``need`` ran, no
    training or ResNet kernel did."""
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{phase}: kernel {name} was not "
                                 f"launched")
    for name in TRAINING_KERNELS + ("fused_bottleneck", "adam_update"):
        if counts[name] != 0:
            raise AssertionError(f"{phase}: kernel {name} launched "
                                 f"{counts[name]} times while serving")
    return counts


def phase_engine_prefix(torch, dev, model):
    """A 1024-token system prompt shared by 8 requests (tails 40-540
    tokens, 32 new tokens each, 8 slots, 96 pages): the cache on and
    off, each on the kernel and the plain path. Gates: the hits, the
    cache audits, the serving kernels launched on the cached kernel run
    (training kernels at 0), the chained prefill's logits within
    ``MODEL_REL_TOL`` of a fresh prefill of the whole prompt and of the
    chained plain path."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    import numpy as np
    from paddle_tpu_torch.serving.prefix_cache import PrefixCache
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(5)
    system = torch.randint(0, V, (PREFIX_SYSTEM,), generator=gen).tolist()
    tails = [torch.randint(0, V, (n,), generator=gen).tolist()
             for n in PREFIX_TAILS]
    prompts = [np.asarray(system + t, np.int32) for t in tails]

    parity = []
    for tail in (tails[0], tails[-1]):
        ck, fk = chained_logits(torch, model, system, tail, plain=False)
        cp, _ = chained_logits(torch, model, system, tail, plain=True)
        rec = {"tail": len(tail),
               "chained_vs_fresh_rel": rel_err(ck, fk),
               "chained_kernel_vs_plain_rel": rel_err(ck, cp),
               "argmax_equal": bool(torch.equal(ck.argmax(-1),
                                                fk.argmax(-1)))}
        parity.append(rec)
        for key in ("chained_vs_fresh_rel", "chained_kernel_vs_plain_rel"):
            if not rec[key] <= MODEL_REL_TOL:
                raise AssertionError(f"engine_prefix tail {len(tail)}: "
                                     f"{key} {rec[key]:.3g} > "
                                     f"{MODEL_REL_TOL}")
    _free_engine_memory(torch)

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for cache_on in (True, False):
        for plain in (False, True):
            pc = PrefixCache(PREFIX_PAGE) if cache_on else None
            if cache_on and not plain:
                reset_launch_counts()
            outs, stats, info = run_cached_engine(
                torch, model, prompts, PREFIX_NEW, plain, pc)
            if cache_on and not plain:
                info["launches"] = serving_launch_gate(
                    "engine_prefix", launch_counts())
            if cache_on:
                if [s.cached_pages for s in stats[1:]] != \
                        [PREFIX_SYSTEM // PREFIX_PAGE] * (len(prompts) - 1):
                    raise AssertionError(f"engine_prefix: cached pages "
                                         f"{info['cached_pages']}")
                if not (pc.hit_rate() or 0) > 0:
                    raise AssertionError("engine_prefix: hit_rate 0")
                info["hit_rate"] = pc.hit_rate()
                info["hit_pages"] = pc.hit_pages
            for o in outs:
                if len(o) != PREFIX_NEW or not all(0 <= t < V for t in o):
                    raise AssertionError(f"engine_prefix: bad generation "
                                         f"{o[:8]}")
            runs[(cache_on, plain)] = (outs, info)
            _free_engine_memory(torch)
    on_k, off_k = runs[(True, False)], runs[(False, False)]
    emit({"phase": "engine_prefix", "ok": True, "model": "gpt_1p3b",
          "system_tokens": PREFIX_SYSTEM, "tails": list(PREFIX_TAILS),
          "max_new_tokens": PREFIX_NEW, "tol_rel": MODEL_REL_TOL,
          "parity": parity,
          "token_agreement_cache_on_vs_off": _agreement(on_k[0], off_k[0]),
          "token_agreement_cache_on_kernel_vs_plain": _agreement(
              on_k[0], runs[(True, True)][0]),
          "cache_on": on_k[1], "cache_off": off_k[1],
          "cache_on_plain": runs[(True, True)][1],
          "cache_off_plain": runs[(False, True)][1],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


SPILL_TAILS = (40, 150, 300, 460)
SPILL_NEW = 16
SPILL_PAGES = 40
SPILL_BYTES = 2 << 30


def _spill_waves(torch, V):
    import numpy as np
    gen = torch.Generator().manual_seed(6)
    waves = []
    for _ in range(2):
        system = torch.randint(0, V, (PREFIX_SYSTEM,),
                               generator=gen).tolist()
        waves.append([np.asarray(system + torch.randint(
            0, V, (n,), generator=gen).tolist(), np.int32)
            for n in SPILL_TAILS])
    return waves


def _timed(torch, fn, sink):
    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def phase_engine_spill(torch, dev, model):
    """Wave A (a system prompt and 4 tails), then wave B (another system
    prompt) in a 40-page pool, which must evict A's chain into the ~2 GB
    host tier, then wave A again: its chain comes back by restore. Gates:
    pages restored, every restored page re-reads byte-equal to its blob,
    the cache audits, and the serving kernels launched: all four over
    wave B and wave A again (wave B's fresh prefills run
    ``attention_fwd``, its evictions spill A's chain), the decode and
    sampling kernels in wave A again alone, whose prefills are all
    chained. Reports ``_read_page`` ms a page, ``_splice_page`` ms a
    run, and token agreement with the same waves without a tier."""
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.serving.prefix_cache import (PrefixCache,
                                                       unpack_page_blob)
    V = model.config.vocab_size
    wave_a, wave_b = _spill_waves(torch, V)
    results = {}
    for spill in (True, False):
        pc = PrefixCache(PREFIX_PAGE,
                         spill_bytes=SPILL_BYTES if spill else None)
        eng = create_decode_engine(model, device=dev, num_slots=4,
                                   page_size=PREFIX_PAGE,
                                   num_pages=SPILL_PAGES, prefix_cache=pc)
        read_ms, splice_ms, restored, restored_runs = [], [], set(), []
        widest = []  # the largest run's blocks, for a warm re-splice
        if spill:
            timed_splice = _timed(torch, eng._splice_page, splice_ms)

            def splice(pages, layers_list):
                if not widest or len(layers_list) > len(widest[0]):
                    widest[:] = [layers_list]
                return timed_splice(pages, layers_list)

            pc.attach_device_io(_timed(torch, eng._read_page, read_ms),
                                splice)
            restore = pc.restore_from_spill

            def spy(*args, **kw):
                keys, pages, info = restore(*args, **kw)
                restored.update(keys)
                if keys:
                    restored_runs.append(len(keys))
                return keys, pages, info

            pc.restore_from_spill = spy
        outs, counts = [], []
        for wave in (wave_a, wave_b, wave_a):
            if spill and wave is wave_a and outs:
                blobs = {k: pc.tiers[0]._load(k)
                         for k in list(pc.tiers[0]._index)}
            if spill and outs:
                reset_launch_counts()
            rids = [eng.submit(p, max_new_tokens=SPILL_NEW) for p in wave]
            res = eng.run()  # audits the cache (check_consistent)
            if spill and outs:
                counts.append(launch_counts())
            outs.append([res[r][len(p):].tolist()
                         for r, p in zip(rids, wave)])
        info = {"spilled_pages": pc.spilled_pages,
                "restored_pages": pc.restored_pages,
                "evicted_pages": pc.evicted_pages,
                "hit_rate": pc.hit_rate(), "tiers": pc.tier_stats()}
        if spill:
            if not pc.restored_pages > 0:
                raise AssertionError("engine_spill: nothing restored")
            checked = 0
            for key, ent in pc._entries.items():
                if key not in restored or key not in blobs:
                    continue
                for a, b in zip(eng._read_page(ent.page),
                                unpack_page_blob(blobs[key])):
                    for x, y in zip(a, b):
                        if (x is None) != (y is None) or (
                                x is not None and
                                x.tobytes() != y.tobytes()):
                            raise AssertionError(
                                f"engine_spill: restored page {ent.page} "
                                f"differs from its blob")
                checked += 1
            if not checked:
                raise AssertionError("engine_spill: no restored page left "
                                     "to check")
            launches = {name: counts[0][name] + counts[1][name]
                        for name in counts[0]}
            serving_launch_gate("engine_spill", launches)
            serving_launch_gate("engine_spill wave A again", counts[1],
                                need=("paged_decode", "decode_out_proj",
                                      "fused_argmax"))
            info.update(launches_wave_b=counts[0],
                        launches_wave_a_again=counts[1])
            # the widest run again, warm (its staging blocks cached by
            # PyTorch's host allocator), into the scratch page only:
            # its content is garbage by contract
            run = widest[0]
            warm = []
            for _ in range(3):
                _timed(torch, eng._splice_page, warm)(
                    [eng._scratch] * len(run), run)
            info.update(pages_checked_byte_equal=checked,
                        read_page_ms=_pct(read_ms, 0.5),
                        read_pages=len(read_ms),
                        splice_run_ms=_pct(splice_ms, 0.5),
                        splice_runs_ms=splice_ms,
                        splice_run_pages=restored_runs,
                        splice_warm_ms=_pct(warm, 0.5),
                        splice_warm_pages=len(run),
                        read_page_mb=(2 * model.config.num_layers
                                      * PREFIX_PAGE * model.config.hidden_size
                                      * 4) / 1e6)
            del blobs
        eng.close()  # clears the cache and its tier; asserts no leak
        if any(t.blob_count for t in pc.tiers):
            raise AssertionError("engine_spill: tier blobs left after "
                                 "close")
        results[spill] = (outs, info)
        del eng, pc
        _free_engine_memory(torch)
    emit({"phase": "engine_spill", "ok": True, "model": "gpt_1p3b",
          "num_pages": SPILL_PAGES, "spill_bytes": SPILL_BYTES,
          "tails": list(SPILL_TAILS), "max_new_tokens": SPILL_NEW,
          "spill": results[True][1], "no_spill": results[False][1],
          "token_agreement_vs_no_spill": _agreement(
              sum(results[True][0], []), sum(results[False][0], [])),
          "token_agreement_wave_a_again_vs_first": _agreement(
              results[True][0][2], results[True][0][0])})


RESURRECT_LENGTHS = (50, 300, 700, 1200)
RESURRECT_NEW = 32


def _arm_when_decoding(server, n):
    """Arm ``engine.step`` for its next two calls, on the engine thread,
    at the first step that finds ``n`` requests in flight, each holding
    a token: the fault lands mid-decode whatever the client threads'
    pace."""
    from paddle_tpu_torch.distributed import fault_inject as fi
    eng = server.engine
    step = eng.step

    def arming_step():
        live = eng.dump_inflight()
        if not fi.get_injector().armed("engine.step") and \
                len(live) == n and all(r.generated for r in live):
            fi.get_injector().arm("engine.step", at_calls=(1, 2))
        return step()

    eng.step = arming_step


def _serve(torch, dev, model, prompts, max_new, arm: bool):
    """The prompts as concurrent streaming clients of one server (prefix
    cache on, its default); with ``arm`` the engine dies mid-decode and
    is resurrected. Returns replies, streams, the counters, the restart
    count, a later request's reply, the leak check, the tokens each
    request held at each resurrection, and the kernel launch counts of
    the engine before the crash and of the rebuilt one (with ``arm``:
    the counts are read and set to 0 on the engine thread as the
    rebuild starts, and read again after the last request)."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.core.monitor import StatRegistry
    from paddle_tpu_torch.serving.metrics import ServingMetrics
    from paddle_tpu_torch.serving.server import ServingServer, client_request
    # counters of this server alone (the default registry is the
    # process's, shared with the server phase)
    server = ServingServer(model, device=dev, num_slots=8,
                           page_size=PREFIX_PAGE, num_pages=96,
                           max_engine_errors=2,
                           metrics=ServingMetrics(registry=StatRegistry()))
    launches = {}
    if arm:
        _arm_when_decoding(server, len(prompts))
        build = server._build_engine

        def counted_build():
            launches["before_crash"] = launch_counts()
            reset_launch_counts()
            return build()

        server._build_engine = counted_build
        reset_launch_counts()
    port = server.start()
    replies = [None] * len(prompts)
    streams = [[] for _ in prompts]

    def one(i):
        replies[i] = client_request(
            "127.0.0.1", port,
            {"op": "generate", "prompt": prompts[i],
             "max_new_tokens": max_new, "stream": True}, timeout_s=300,
            on_token=streams[i].append)

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        later = client_request("127.0.0.1", port,
                               {"op": "generate", "prompt": prompts[0],
                                "max_new_tokens": 4}, timeout_s=300)
        stats = client_request("127.0.0.1", port, {"op": "stats"})
        leak = client_request("127.0.0.1", port, {"op": "leak_check"})
        health = client_request("127.0.0.1", port, {"op": "health"})
    finally:
        server.stop()
    if arm:
        launches["rebuilt"] = launch_counts()
    # tokens each request held when the engine died (the resurrection's
    # snapshot)
    held = [[g for _r, _p, g, _s in e["args"]["rids"]]
            for e in server.tracer.events() if e["name"] == "resurrect"]
    return (replies, streams, stats["stats"]["counters"],
            health.get("engine_restarts"), later, leak, held, launches)


def phase_server_resurrect(torch, dev, model):
    """Four streaming requests of 50-1200 tokens; ``engine.step`` fails
    twice once every request holds tokens (``max_engine_errors=2``): the
    server resurrects the engine and replays them. Gates: each stream
    equals its reply's tokens (no duplicate, no gap), each reply is
    ``replayed``, one restart, the leak check, a later request served,
    the serving kernels launched by the engine before the crash and by
    the rebuilt one (its replay prefills run ``attention_fwd``);
    at the engine level, a prefill of prompt + emitted token gives the
    decode step's logits at that position within ``MODEL_REL_TOL`` on
    the kernel path. Reports token agreement with a fault-free run."""
    from paddle_tpu_torch.distributed import fault_inject as fi
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, V, (n,), generator=gen).tolist()
               for n in RESURRECT_LENGTHS]
    parity = []
    for prompt in (prompts[1], prompts[3]):
        _h, _l, tok, _h2, l2 = path_outputs(torch, model, prompt, False)
        _h, lrep, _t, _h2, _l2 = path_outputs(
            torch, model, prompt + [int(tok[0])], False)
        rec = {"prompt": len(prompt),
               "replay_prefill_vs_decode_logits_rel": rel_err(lrep, l2),
               "argmax_equal": bool(torch.equal(lrep.argmax(-1),
                                                l2.argmax(-1)))}
        parity.append(rec)
        if not rec["replay_prefill_vs_decode_logits_rel"] <= MODEL_REL_TOL:
            raise AssertionError(f"server_resurrect parity: {rec}")
    _free_engine_memory(torch)
    try:
        (replies, streams, counters, restarts, later, leak, held,
         launches) = _serve(torch, dev, model, prompts, RESURRECT_NEW,
                            arm=True)
    finally:
        fi.reset()  # no later phase may meet an armed site
    _free_engine_memory(torch)
    for i, r in enumerate(replies):
        if not r or not r.get("done") or \
                len(r["generated"]) != RESURRECT_NEW:
            raise AssertionError(f"server_resurrect generate {i}: {r}")
        if streams[i] != r["generated"]:
            raise AssertionError(f"server_resurrect stream {i} != reply "
                                 f"({len(streams[i])} streamed)")
        if r["stats"].get("replayed") is not True:
            raise AssertionError(f"server_resurrect reply {i} not "
                                 f"replayed")
        if r["tokens"] != prompts[i] + r["generated"]:
            raise AssertionError(f"server_resurrect reply {i} tokens")
    if counters.get("engine_restarts_total") != 1 or restarts != 1:
        raise AssertionError(f"server_resurrect restarts "
                             f"{counters.get('engine_restarts_total')}")
    # every token counted once, pre-crash ones included (+4: the later
    # request)
    want_tokens = len(prompts) * RESURRECT_NEW + 4
    if counters.get("tokens_generated_total") != want_tokens:
        raise AssertionError(f"server_resurrect tokens_generated_total "
                             f"{counters.get('tokens_generated_total')} != "
                             f"{want_tokens}")
    if not leak.get("ok"):
        raise AssertionError(f"server_resurrect leak_check {leak}")
    if not later.get("done") or len(later["generated"]) != 4:
        raise AssertionError(f"server_resurrect later request {later}")
    if sorted(launches) != ["before_crash", "rebuilt"]:
        raise AssertionError(f"server_resurrect: no rebuild seen "
                             f"({sorted(launches)})")
    serving_launch_gate("server_resurrect before the crash",
                        launches["before_crash"])
    serving_launch_gate("server_resurrect rebuilt engine",
                        launches["rebuilt"])
    clean = _serve(torch, dev, model, prompts, RESURRECT_NEW,
                   arm=False)[0]
    _free_engine_memory(torch)
    emit({"phase": "server_resurrect", "ok": True, "model": "gpt_1p3b",
          "prompt_lengths": list(RESURRECT_LENGTHS),
          "max_new_tokens": RESURRECT_NEW, "tol_rel": MODEL_REL_TOL,
          "parity": parity, "engine_restarts_total": 1,
          "tokens_held_at_crash": held,
          "replayed_requests_total": counters.get("replayed_requests_total"),
          "tokens_generated_total": counters.get("tokens_generated_total"),
          "token_agreement_vs_fault_free": _agreement(
              [r["generated"] for r in replies],
              [r["generated"] for r in clean]),
          "leak_check": leak.get("ok"),
          "cached_pages_after": leak.get("cached_pages"),
          "launches": launches})


# -- phase 5e-5g: chunked prefill and speculative decoding ----------------------

CHUNK_TOKENS = 256
CHUNK_LENGTHS = (300, 500, 700, 900, 1100, 1300, 1500, 1700)
CHUNK_NEW = 32
CHUNK_DEDUP_LEN = 700     # two identical prompts: 10 full pages to fold
SPEC_K = 4
SPEC_LENGTHS = (130, 200, 300, 400, 500, 600, 700, 800)
SPEC_NEW = 32
SPEC_WINDOW = 64
SERVER_CHUNKED_LENGTHS = (50, 300, 700, 1200)


def _bucket(n):
    """The engine's prompt bucket of ``n`` tokens at page 64."""
    b = PREFIX_PAGE
    while b < n:
        b *= 2
    return b


def chunked_logits(torch, model, prompt, chunk):
    """Last-row logits of ``prompt`` prefilled as the chunked engine does
    it (a fresh dense first chunk, then chained chunks, each padded to
    ``chunk`` ids), and of one whole prefill padded to its bucket, both
    on the kernel path."""
    from paddle_tpu_torch.models.gpt import paged_cache_create
    cfg = model.config
    dev = model.device
    mp = -(-cfg.max_seq_len // PREFIX_PAGE)

    def caches():
        return [paged_cache_create(1, mp, PREFIX_PAGE, cfg.num_heads,
                                   cfg.head_dim, torch.float32, mp,
                                   device=dev)
                for _ in range(cfg.num_layers)]

    def padded(toks, width):
        ids = torch.zeros((1, width), dtype=torch.int64, device=dev)
        ids[0, :len(toks)] = torch.tensor(toks, dtype=torch.int64)
        return ids

    def lens(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)

    with torch.no_grad():
        cs = caches()
        for done in range(0, len(prompt), chunk):
            part = prompt[done:done + chunk]
            h, cs = model.decode_hidden(padded(part, chunk), cs,
                                        prefill_lens=lens(len(part)),
                                        prefill_chained=done > 0,
                                        fused=True)
        chunked = model.logits(h[:, len(part) - 1].contiguous())
        n = len(prompt)
        h2, _ = model.decode_hidden(padded(prompt, _bucket(n)), caches(),
                                    prefill_lens=lens(n), fused=True)
        whole = model.logits(h2[:, n - 1].contiguous())
    return chunked, whole


def run_stepped_engine(torch, model, prompts, max_new, **engine_kw):
    """``prompts`` through one engine (8 slots, page 64, a full pool),
    stepped until it drains: generated tokens, per-request stats and run
    info. Each prefill launch (a whole prefill or a chunk) and each
    verify is timed on the host around its call, which returns only once
    its token is on the host; ``prefill_debt_tokens`` is read after
    every step. ``run()`` then audits the books and ``close()`` asserts
    ``check_no_leak``."""
    from paddle_tpu_torch.inference import create_decode_engine
    done = {}
    eng = create_decode_engine(model, device=model.device, num_slots=8,
                               page_size=PREFIX_PAGE, timeline_steps=4096,
                               on_complete=lambda r: done.__setitem__(
                                   r.req_id, r), **engine_kw)
    launches = {"fresh": [], "chained": [], "verify": []}

    def timed(fn, key_of):
        def run(*a):
            t0 = time.monotonic()
            out = fn(*a)
            launches[key_of(*a)].append((time.monotonic() - t0) * 1e3)
            return out
        return run

    eng._run_prefill = timed(
        eng._run_prefill,
        lambda row, ids, plen, cached_len=0: ("chained" if cached_len
                                              else "fresh"))
    eng._run_verify = timed(eng._run_verify, lambda *a: "verify")
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    debt = [eng.prefill_debt_tokens]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    while eng.num_queued or eng.num_active:
        eng.step()
        debt.append(eng.prefill_debt_tokens)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    res = eng.run()
    outs = [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]
    stats = [done[r].stats for r in rids]
    tl = eng.step_timeline()
    dec = sorted(e["decode_ms"] for e in tl if "decode_ms" in e)
    dec_chunk = sorted(e["decode_ms"] for e in tl
                       if "decode_ms" in e and "chunk_ms" in e)
    ttft = [s.ttft_s * 1e3 for s in stats]
    info = {"wall_s": wall, "steps": eng.steps,
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "decode_step_ms_median": dec[len(dec) // 2] if dec else None,
            "decode_step_ms_median_chunk_in_flight":
                dec_chunk[len(dec_chunk) // 2] if dec_chunk else None,
            "steps_with_a_chunk_and_a_decode": len(dec_chunk),
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p99": _pct(ttft, 0.99),
            "prefill_debt_tokens_max": max(debt),
            "prefill_debt_tokens_by_step": debt[:64],
            "programs_launched": dict(eng.programs_launched)}
    for key, ms in launches.items():
        if ms:
            info[f"{key}_ms_median"] = sorted(ms)[len(ms) // 2]
            info[f"{key}_ms_max"] = max(ms)
            info[f"{key}_launches"] = len(ms)
    eng.close()
    return outs, stats, info


def _generation_ok(phase, outs, n, V):
    for o in outs:
        if len(o) != n or not all(0 <= t < V for t in o):
            raise AssertionError(f"{phase}: bad generation {o[:8]}")


def phase_engine_chunked(torch, dev, model):
    """Chunked prefill (``prefill_chunk_tokens=256``): 8 requests of
    300-1700 tokens, 32 new tokens, 8 slots, page 64, chunked and
    whole. Gates: each final chunk's last-row logits within
    ``MODEL_REL_TOL`` of a whole prefill of the prompt, the serving
    kernels launched on the chunked run (``attention_fwd`` by the fresh
    first chunks) and the training kernels at 0, no leak; then two
    identical prompts with the cache on fold pages (``dedup_hits > 0``)
    and give the tokens of ``dedup=False``. Reports token agreement,
    fresh and chained chunk ms, the decode step with chunks in flight,
    TTFT chunked against whole and the prefill debt over the run."""
    import numpy as np
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.serving.prefix_cache import PrefixCache
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
               for n in CHUNK_LENGTHS]
    parity = []
    for p in (prompts[0], prompts[-1]):
        ck, wh = chunked_logits(torch, model, p.tolist(), CHUNK_TOKENS)
        rec = {"prompt": len(p), "chunks": -(-len(p) // CHUNK_TOKENS),
               "final_chunk_vs_whole_rel": rel_err(ck, wh),
               "argmax_equal": bool(torch.equal(ck.argmax(-1),
                                                wh.argmax(-1)))}
        parity.append(rec)
        if not rec["final_chunk_vs_whole_rel"] <= MODEL_REL_TOL:
            raise AssertionError(f"engine_chunked parity: {rec}")
    _free_engine_memory(torch)
    reset_launch_counts()
    outs_c, stats_c, info_c = run_stepped_engine(
        torch, model, prompts, CHUNK_NEW, prefill_chunk_tokens=CHUNK_TOKENS)
    info_c["launches"] = serving_launch_gate("engine_chunked",
                                             launch_counts())
    want_chunks = [-(-n // CHUNK_TOKENS) for n in CHUNK_LENGTHS]
    if [s.prefill_chunks for s in stats_c] != want_chunks:
        raise AssertionError(f"engine_chunked chunks "
                             f"{[s.prefill_chunks for s in stats_c]}")
    _free_engine_memory(torch)
    outs_w, _stats_w, info_w = run_stepped_engine(torch, model, prompts,
                                                  CHUNK_NEW)
    _free_engine_memory(torch)
    for outs in (outs_c, outs_w):
        _generation_ok("engine_chunked", outs, CHUNK_NEW, V)
    same = torch.randint(0, V, (CHUNK_DEDUP_LEN,), generator=gen).numpy()
    dedup = {}
    for on in (True, False):
        pc = PrefixCache(PREFIX_PAGE, dedup=on)
        outs, _s, _i = run_stepped_engine(
            torch, model, [same, same.copy()], 8,
            prefill_chunk_tokens=CHUNK_TOKENS, prefix_cache=pc)
        dedup[on] = (outs, pc.dedup_hits)
        _free_engine_memory(torch)
    if not dedup[True][1] > 0 or dedup[False][1] != 0:
        raise AssertionError(f"engine_chunked dedup_hits "
                             f"{dedup[True][1]} / {dedup[False][1]}")
    if dedup[True][0] != dedup[False][0]:
        raise AssertionError("engine_chunked: dedup on and off differ")
    emit({"phase": "engine_chunked", "ok": True, "model": "gpt_1p3b",
          "chunk_tokens": CHUNK_TOKENS, "prompt_lengths": list(CHUNK_LENGTHS),
          "max_new_tokens": CHUNK_NEW, "tol_rel": MODEL_REL_TOL,
          "parity": parity,
          "token_agreement_chunked_vs_whole": _agreement(outs_c, outs_w),
          "chunked": info_c, "whole": info_w,
          "dedup": {"prompt": CHUNK_DEDUP_LEN,
                    "dedup_hits": dedup[True][1],
                    "tokens_equal_dedup_off": True}})


def verify_vs_decode_logits(torch, model, prompt, k):
    """Logits of one verify forward over ``[t_0 .. t_k]`` (the greedy
    continuation of ``prompt``) against the vanilla decode step's at
    each of those positions, both on the kernel path: the decode steps
    run ``paged_decode`` and ``decode_out_proj``, the verify the chained
    dense-gather path. Returns the relative error a position."""
    from paddle_tpu_torch.models.gpt import paged_cache_create
    cfg = model.config
    dev = model.device
    mp = -(-cfg.max_seq_len // PREFIX_PAGE)
    n = len(prompt)

    def prefilled():
        cs = [paged_cache_create(1, mp, PREFIX_PAGE, cfg.num_heads,
                                 cfg.head_dim, torch.float32, mp,
                                 device=dev)
              for _ in range(cfg.num_layers)]
        ids = torch.zeros((1, _bucket(n)), dtype=torch.int64, device=dev)
        ids[0, :n] = torch.tensor(prompt, dtype=torch.int64)
        h, cs = model.decode_hidden(
            ids, cs, prefill_lens=torch.tensor([n], dtype=torch.int32,
                                               device=dev), fused=True)
        return model.logits(h[:, n - 1].contiguous()), cs

    with torch.no_grad():
        first, cs = prefilled()
        toks = [int(first.argmax(-1)[0])]
        dec = []
        for _ in range(k + 1):
            h, cs = model.decode_hidden(
                torch.tensor([[toks[-1]]], dtype=torch.int64, device=dev),
                cs, fused=True)
            dec.append(model.logits(h[:, -1].contiguous()))
            toks.append(int(dec[-1].argmax(-1)[0]))
        _, cs = prefilled()
        ids = torch.tensor([toks[:k + 1]], dtype=torch.int64, device=dev)
        h, _ = model.decode_hidden(
            ids, cs, prefill_lens=torch.tensor([k + 1], dtype=torch.int32,
                                               device=dev),
            prefill_chained=True, fused=True)
        ver = model.logits(h[0].contiguous())
    return [rel_err(ver[j:j + 1], dec[j]) for j in range(k + 1)]


def phase_engine_spec(torch, dev, model, records):
    """Speculative decoding, k=4, 8 slots, 8 requests of 130-800 tokens,
    32 new tokens, with three drafts: the n-gram draft, a ModelDraft of
    the target itself (window 64), an always-wrong draft and an oracle
    draft (the vanilla run's own next tokens). Gates:
    verify position j's logits within ``MODEL_REL_TOL`` of the vanilla
    decode step's there; on each run ``fused_argmax`` launched once a
    prefill and once a verify (the verify's over 8 x 5 = 40 rows) and
    the training kernels at 0; the always-wrong draft accepts nothing;
    no leak. Reports each draft's acceptance rate, tokens a step, the
    verify step and token agreement with the vanilla engine."""
    from paddle_tpu_torch.inference import (CallableDraft, ModelDraft,
                                            SpeculativeConfig)
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
               for n in SPEC_LENGTHS]
    parity = []
    for p in (prompts[0], prompts[-1]):
        rels = verify_vs_decode_logits(torch, model, p.tolist(), SPEC_K)
        parity.append({"prompt": len(p), "verify_vs_decode_rel": rels})
        if not max(rels) <= MODEL_REL_TOL:
            raise AssertionError(f"engine_spec parity {len(p)}: {rels}")
    _free_engine_memory(torch)
    outs_v, _s, info_v = run_stepped_engine(torch, model, prompts, SPEC_NEW)
    _free_engine_memory(torch)
    # the oracle proposes the vanilla run's own next tokens: every
    # draft the verify should accept, but for near-ties between the
    # verify's dense-gather path and the decode kernels
    full = [p.tolist() + o for p, o in zip(prompts, outs_v)]

    def oracle(h, k):
        n = len(h)
        for f in full:
            if len(f) > n and f[:8] == h[:8].tolist():
                cont = f[n:n + k]
                return cont + [cont[-1]] * (k - len(cont))
        return [0] * k

    drafts = (("ngram", "ngram"),
              ("model_self_window64", ModelDraft(model, window=SPEC_WINDOW)),
              ("always_wrong", CallableDraft(
                  lambda h, k: [(int(h[-1]) + 7) % V] * k)),
              ("oracle_vanilla_tokens", CallableDraft(oracle)))
    runs = {}
    for tag, draft in drafts:
        reset_launch_counts()
        outs, stats, info = run_stepped_engine(
            torch, model, prompts, SPEC_NEW,
            speculative=SpeculativeConfig(k=SPEC_K, draft=draft))
        counts = serving_launch_gate(f"engine_spec {tag}", launch_counts(),
                                     need=("fused_argmax", "attention_fwd"))
        progs = info["programs_launched"]
        heads = progs.get("verify", 0) + progs.get("prefill", 0) + \
            progs.get("prefill_chained", 0)
        if progs.get("verify", 0) <= 0 or counts["fused_argmax"] != heads:
            raise AssertionError(f"engine_spec {tag}: fused_argmax "
                                 f"{counts['fused_argmax']} launches for "
                                 f"{progs}")
        if counts["paged_decode"] or counts["decode_out_proj"]:
            raise AssertionError(f"engine_spec {tag}: a decode step ran "
                                 f"({counts})")
        _generation_ok(f"engine_spec {tag}", outs, SPEC_NEW, V)
        drafted = sum(s.spec_drafted for s in stats)
        accepted = sum(s.spec_accepted for s in stats)
        steps = sum(s.spec_steps for s in stats)
        if tag == "always_wrong" and accepted != 0:
            raise AssertionError(f"engine_spec always_wrong accepted "
                                 f"{accepted}")
        info.update(launches=counts, drafted=drafted, accepted=accepted,
                    acceptance_rate=accepted / max(drafted, 1),
                    tokens_per_step=sum(s.tokens_out - 1 for s in stats)
                    / max(steps, 1),
                    token_agreement_vs_vanilla=_agreement(outs, outs_v))
        runs[tag] = info
        if tag == "ngram":
            # one fused_argmax launch at the verify's 40 rows a verify
            records["fused_argmax"]["verify_shape"]["launches"] = \
                progs["verify"]
        _free_engine_memory(torch)
    emit({"phase": "engine_spec", "ok": True, "model": "gpt_1p3b",
          "k": SPEC_K, "prompt_lengths": list(SPEC_LENGTHS),
          "max_new_tokens": SPEC_NEW, "tol_rel": MODEL_REL_TOL,
          "parity": parity, "vanilla": info_v, "drafts": runs})


def phase_server_chunked_spec(torch, dev, model):
    """The server with ``prefill_chunk_tokens=256`` and ``speculative=4``:
    4 requests of 50-1200 tokens (2 streaming), 16 new tokens each, then
    ``stats`` and ``leak_check``. Gates: each stream equals its reply,
    every reply carries its chunk count and spec stats, the stats op's
    histograms hold the 4 requests, the leak check passes."""
    from paddle_tpu_torch.serving.server import ServingServer, client_request
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(17)
    lengths = SERVER_CHUNKED_LENGTHS
    prompts = [torch.randint(0, V, (n,), generator=gen).tolist()
               for n in lengths]
    server = ServingServer(model, device=dev, num_slots=8,
                           page_size=PREFIX_PAGE,
                           prefill_chunk_tokens=CHUNK_TOKENS,
                           speculative=SPEC_K)
    port = server.start()
    replies = [None] * 4
    streamed = [[] for _ in range(4)]

    def one(i):
        replies[i] = client_request(
            "127.0.0.1", port,
            {"op": "generate", "prompt": prompts[i], "max_new_tokens": 16,
             "stream": i < 2}, timeout_s=300, on_token=streamed[i].append)

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i, r in enumerate(replies):
            if not r or not r.get("done") or len(r["generated"]) != 16:
                raise AssertionError(f"server_chunked_spec {i}: {r}")
            if i < 2 and streamed[i] != r["generated"]:
                raise AssertionError(f"server_chunked_spec stream {i}")
            st = r["stats"]
            if st.get("prefill_chunks") != -(-lengths[i] // CHUNK_TOKENS) \
                    or not st.get("spec_steps"):
                raise AssertionError(f"server_chunked_spec stats {i}: {st}")
        stats = client_request("127.0.0.1", port, {"op": "stats"})
        leak = client_request("127.0.0.1", port, {"op": "leak_check"})
        snap = stats["stats"]
        if snap["spec_accept_rate"]["count"] != 4 or \
                snap["prefill_chunks"]["count"] != 4 or not leak.get("ok"):
            raise AssertionError(f"server_chunked_spec ops: {leak} "
                                 f"{snap['spec_accept_rate']}")
        emit({"phase": "server_chunked_spec", "ok": True,
              "prompt_lengths": list(lengths),
              "prefill_chunks": [r["stats"]["prefill_chunks"]
                                 for r in replies],
              "acceptance_rate": [r["stats"].get("acceptance_rate")
                                  for r in replies],
              "tokens_per_step": [r["stats"].get("tokens_per_step")
                                  for r in replies],
              "ttft_ms": [r["stats"].get("ttft_s", 0) * 1e3
                          for r in replies],
              "programs_launched": stats["programs_launched"],
              "leak_check": leak.get("ok")})
    finally:
        server.stop()
    _free_engine_memory(torch)


# -- phase 5h-5i: multi-step decode ------------------------------------------

MULTI_STEPS = (1, 4, 8)
MULTI_CHUNK_N = 8          # in-program chunks: chunk 256 at N=8
MULTI_SPEC_N = 4           # in-program n-gram speculation, k=4, at N=4
MULTI_LAYERS = 4           # the pool-dtype checks and the server
MULTI_PROFILE_NEW = 64     # long enough for 4 steady launches at N=8
MULTI_PROFILE_LENGTHS = (300, 500, 700, 900, 1100, 1300, 1500, 1700)
MULTI_SERVER_LENGTHS = (300, 700)
MULTI_SERVER_NEW = 32
# the host's CUDA API calls that start device work: a kernel, a graph
# replay or a copy (torch.profiler records them on the CPU side)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
               "cudaLaunchKernelEx", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
               "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2",
               "cuMemcpyDtoHAsync_v2")
GRAPH_KERNEL_NAMES = ("paged_decode_kernel", "out_proj_kernel",
                      "argmax_tiles_kernel")


def _multi_model(torch, dev, dtype="float32"):
    """GPT-1.3B's widths at ``MULTI_LAYERS`` layers, seed-0 weights."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(hidden_size=2048, num_layers=MULTI_LAYERS,
                    num_heads=16, max_seq_len=2048, dtype=dtype)
    model = GPTForCausalLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    model.eval()
    return model


def run_multi_engine(torch, model, prompts, max_new, eos=None,
                     **engine_kw):
    """``prompts`` through one engine (8 slots, page 64, 96 pages) run to
    the end, ``eos`` = (request, token) an EOS on that request: the
    generated tokens and the
    run's wall time, tokens/s, ms a token, macro launches, iterations a
    launch, iterations that ran masked only (every slot stopped), the
    graphs' kernel nodes and wrapper launches a replay."""
    from paddle_tpu_torch.inference import create_decode_engine
    eng = create_decode_engine(model, device=model.device, num_slots=8,
                               page_size=PREFIX_PAGE, num_pages=96,
                               timeline_steps=4096, **engine_kw)
    rids = [eng.submit(p, max_new_tokens=max_new,
                       eos_token=(eos[1] if eos is not None and i == eos[0]
                                  else None))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    outs = [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]
    macros = [e["macro"] for e in eng.step_timeline() if "macro" in e]
    iters = sum(m["steps"] for m in macros)
    tokens = sum(len(o) for o in outs)
    info = {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "ms_per_token": wall * 1e3 / tokens,
            "macro_launches": eng.macro_launches,
            "iterations_per_launch": (iters / len(macros) if macros
                                      else None),
            "masked_iterations": sum(m["masked_steps"] for m in macros),
            "programs_launched": dict(eng.programs_launched),
            "step_programs": dict(eng.step_programs)}
    if eng._macro is not None and eng._macro["graphs"] is not None:
        info["graphs"] = eng._macro["graphs"].kinds()
    eng.close()
    return outs, info


def profile_multi_steps(torch, model, n, **engine_kw):
    """Device time against wall time over steady launches at 8 slots
    (torch.profiler): N=1 over 10 per-token steps, N>1 over 3 macro
    launches, each drained inside the window; ``engine_kw`` adds chunks,
    speculation or int8 pools. Reports ms a token, device kernel ms a
    token, the idle share, the host's launch calls a token (kernels,
    graph replays and copies started from the host) and the device
    kernels' names."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import create_decode_engine
    eng = create_decode_engine(model, device=model.device, num_slots=8,
                               page_size=PREFIX_PAGE, multi_step=n,
                               **engine_kw)
    gen = torch.Generator().manual_seed(1)
    delivered = [0]

    def count(_rid, _tok, _done):
        delivered[0] += 1

    for length in MULTI_PROFILE_LENGTHS:
        eng.submit(torch.randint(0, model.config.vocab_size, (length,),
                                 generator=gen).numpy(),
                   max_new_tokens=MULTI_PROFILE_NEW, on_token=count)
    for _ in range(6 if n == 1 else 3):  # admissions, capture, warm steps
        eng.step()
    eng._flush_macro()
    torch.cuda.synchronize()
    before = delivered[0]
    steps = 10 if n == 1 else 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        eng._flush_macro()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    tokens = delivered[0] - before
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    calls = [e for e in prof.events()
             if not str(getattr(e, "device_type", "")).endswith("CUDA")
             and e.name in LAUNCH_APIS]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    names = sorted({e.name for e in kernels})
    eng.close()
    return {"multi_step": n, "window_steps": steps, "tokens": tokens,
            "wall_ms_per_token": wall_ms / tokens,
            "device_kernel_ms_per_token": dev_ms / tokens,
            "device_kernels_per_token": len(kernels) / tokens,
            "host_launch_calls_per_token": len(calls) / tokens,
            "host_launch_calls_by_api": {
                a: sum(e.name == a for e in calls) for a in LAUNCH_APIS
                if any(e.name == a for e in calls)},
            "idle_share": 1.0 - dev_ms / wall_ms,
            "graph_kernels_named": {
                k: any(k in nm for nm in names) for k in GRAPH_KERNEL_NAMES},
            "kernel_names": [nm[:60] for nm in names][:24]}


def _mid_launch_eos(outs):
    """(request, token, index): the first token a request's N=1 stream
    emits at an index i whose iteration lies inside a launch of 4 and of
    8 ((i - 1) mod 4 is 1 or 2: index 0 is the prefill's), emitted there
    for the first time, so as an EOS it ends that stream at i."""
    for j in range(2, max(len(o) for o in outs)):
        if (j - 1) % 4 not in (1, 2):
            continue
        for r, out in enumerate(outs):
            if j < len(out) and out[j] not in out[:j]:
                return r, out[j], j
    raise AssertionError("no stream emits a fresh token mid-launch")


def phase_engine_multi_step(torch, dev, model, prompts):
    """Multi-step decode at full width (GPT-1.3B, 8 slots, page 64, 96
    pages): the engine phase's 8 prompts (40-2000 tokens, 32 new) at
    ``multi_step`` 1, 4 and 8, then an EOS that the N=1 run emits in the
    middle of a launch; ``prefill_chunk_tokens=256`` at N=8 on the
    ``engine_chunked`` prompts against chunked N=1 and whole prefill;
    n-gram speculation k=4 at N=4 on the ``engine_spec`` prompts against
    vanilla decoding; bf16 and int8 pools at N=1 and N=8 at 4 layers.
    Gates: every token list bitwise equal to its reference; on each
    multi-step run the graph path's launch counts (the capture's taken
    back, each replay's added) show ``paged_decode``, ``decode_out_proj``
    and ``fused_argmax`` (the speculative run: ``fused_argmax`` and no
    decode kernel), no training kernel; a profiled replay lists the three
    kernels by name; every ``paged_decode`` ticket buffer reads zero
    after the phase. Reports, per configuration, tokens/s, ms a token,
    launches, iterations a launch, masked iterations, the graphs' kernel
    nodes, and from the profiler the host's launch calls a token and the
    device's idle share over steady launches."""
    import numpy as np
    from paddle_tpu_torch.inference import SpeculativeConfig
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.kernels.paged_attention import ticket_buffers
    V = model.config.vocab_size
    decode_need = ("paged_decode", "decode_out_proj", "fused_argmax")
    runs, outs = {}, {}
    for n in MULTI_STEPS:
        _free_engine_memory(torch)
        reset_launch_counts()
        outs[n], info = run_multi_engine(torch, model, prompts, ENGINE_NEW,
                                         multi_step=n)
        info["launches"] = serving_launch_gate(
            f"engine_multi_step N={n}", launch_counts(), need=decode_need)
        _generation_ok(f"engine_multi_step N={n}", outs[n], ENGINE_NEW, V)
        runs[f"N={n}"] = info
    for n in MULTI_STEPS[1:]:
        check_tokens(f"engine_multi_step tokens N={n} vs N=1", outs[n],
                     outs[1])
    eos_req, eos, at = _mid_launch_eos(outs[1])
    eos_outs = {}
    for n in MULTI_STEPS:
        _free_engine_memory(torch)
        eos_outs[n], _ = run_multi_engine(torch, model, prompts, ENGINE_NEW,
                                          eos=(eos_req, eos), multi_step=n)
        if len(eos_outs[n][eos_req]) != at + 1:
            raise AssertionError(f"engine_multi_step EOS N={n}: "
                                 f"{len(eos_outs[n][eos_req])} tokens, "
                                 f"not {at + 1}")
    for n in MULTI_STEPS[1:]:
        check_tokens(f"engine_multi_step EOS N={n} vs N=1", eos_outs[n],
                     eos_outs[1])

    # in-program chunks against chunked N=1 and whole prefill
    gen = torch.Generator().manual_seed(11)
    chunk_prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
                     for n in CHUNK_LENGTHS]
    _free_engine_memory(torch)
    whole, _s, info_whole = run_stepped_engine(torch, model, chunk_prompts,
                                               CHUNK_NEW)
    _free_engine_memory(torch)
    chunked1, _s, info_c1 = run_stepped_engine(
        torch, model, chunk_prompts, CHUNK_NEW,
        prefill_chunk_tokens=CHUNK_TOKENS)
    _free_engine_memory(torch)
    reset_launch_counts()
    chunked8, stats8, info_c8 = run_stepped_engine(
        torch, model, chunk_prompts, CHUNK_NEW,
        prefill_chunk_tokens=CHUNK_TOKENS, multi_step=MULTI_CHUNK_N)
    info_c8["launches"] = serving_launch_gate(
        "engine_multi_step chunk", launch_counts(),
        need=decode_need + ("attention_fwd",))
    progs = info_c8["programs_launched"]
    if progs.get("prefill_chained", 0) != 0:
        raise AssertionError(f"engine_multi_step chunk: chained chunks "
                             f"ran at the boundary ({progs})")
    _generation_ok("engine_multi_step chunk", chunked8, CHUNK_NEW, V)
    check_tokens("engine_multi_step chunk N=8 vs chunked N=1", chunked8,
                 chunked1)
    check_tokens("engine_multi_step chunk N=8 vs whole prefill", chunked8,
                 whole)

    # in-program speculation against vanilla decoding
    gen = torch.Generator().manual_seed(13)
    spec_prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
                    for n in SPEC_LENGTHS]
    _free_engine_memory(torch)
    vanilla, _s, info_v = run_stepped_engine(torch, model, spec_prompts,
                                             SPEC_NEW)
    _free_engine_memory(torch)
    reset_launch_counts()
    spec, spec_stats, info_s = run_stepped_engine(
        torch, model, spec_prompts, SPEC_NEW, multi_step=MULTI_SPEC_N,
        speculative=SpeculativeConfig(k=SPEC_K, draft="ngram"))
    counts = serving_launch_gate("engine_multi_step spec", launch_counts(),
                                 need=("fused_argmax", "attention_fwd"))
    if counts["paged_decode"] or counts["decode_out_proj"] or \
            info_s["programs_launched"].get("verify", 0):
        raise AssertionError(f"engine_multi_step spec: a decode step or a "
                             f"boundary verify ran ({counts}, "
                             f"{info_s['programs_launched']})")
    info_s["launches"] = counts
    drafted = sum(s.spec_drafted for s in spec_stats)
    info_s["acceptance_rate"] = sum(s.spec_accepted for s in spec_stats) \
        / max(drafted, 1)
    _generation_ok("engine_multi_step spec", spec, SPEC_NEW, V)
    check_tokens("engine_multi_step spec N=4 vs vanilla", spec, vanilla)

    # bf16 and int8 pools at 4 layers
    pools, profiles = {}, {}
    small = _multi_model(torch, dev)
    for tag, m, kw in (("int8", small, dict(kv_int8=True)),
                       ("bf16", _multi_model(torch, dev, "bfloat16"), {})):
        got = {}
        for n in (1, 8):
            _free_engine_memory(torch)
            got[n], info = run_multi_engine(torch, m, prompts, ENGINE_NEW,
                                            multi_step=n, **kw)
            pools[f"{tag} N={n}"] = info
        _generation_ok(f"engine_multi_step {tag}", got[8], ENGINE_NEW, V)
        check_tokens(f"engine_multi_step {tag} pools N=8 vs N=1", got[8],
                     got[1])
        for n in (1, 8):
            profiles[f"{tag} N={n} (4 layers)"] = profile_multi_steps(
                torch, m, n, **kw)
            _free_engine_memory(torch)
        del m
    _free_engine_memory(torch)
    configs = [(f"N={n}", n, {}) for n in MULTI_STEPS] + [
        ("chunk N=1", 1, dict(prefill_chunk_tokens=CHUNK_TOKENS)),
        (f"chunk N={MULTI_CHUNK_N}", MULTI_CHUNK_N,
         dict(prefill_chunk_tokens=CHUNK_TOKENS)),
        (f"spec N={MULTI_SPEC_N}", MULTI_SPEC_N,
         dict(speculative=SpeculativeConfig(k=SPEC_K, draft="ngram")))]
    for tag, n, kw in configs:
        profiles[tag] = profile_multi_steps(torch, model, n, **kw)
        _free_engine_memory(torch)
    for n in MULTI_STEPS[1:]:
        named = profiles[f"N={n}"]["graph_kernels_named"]
        if not all(named.values()):
            raise AssertionError(f"engine_multi_step: profiled replays at "
                                 f"N={n} lack kernels {named}")
    torch.cuda.synchronize()
    tickets = [int(t.abs().sum()) for t in ticket_buffers()]
    if any(tickets):
        raise AssertionError(f"engine_multi_step: paged_decode ticket "
                             f"buffers not zero: {tickets}")
    emit({"phase": "engine_multi_step", "ok": True, "model": "gpt_1p3b",
          "multi_steps": list(MULTI_STEPS), "max_new_tokens": ENGINE_NEW,
          "prompt_lengths": [len(p) for p in prompts], "runs": runs,
          "eos": {"request": eos_req, "token": int(eos), "index": at},
          "chunk": {"multi_step": MULTI_CHUNK_N, "chunk": CHUNK_TOKENS,
                    "prompt_lengths": list(CHUNK_LENGTHS), "whole": info_whole,
                    "chunked_n1": info_c1, "chunked_n8": info_c8},
          "spec": {"multi_step": MULTI_SPEC_N, "k": SPEC_K,
                   "prompt_lengths": list(SPEC_LENGTHS), "vanilla": info_v,
                   "inprogram": info_s},
          "pools_4_layers": pools, "profiles": profiles,
          "ticket_buffers": len(tickets)})
    return small


def phase_server_multi_step(torch, dev, model):
    """The server as ``--multi-step 8`` builds it, at 4 layers: two
    streaming requests of 300 and 700 tokens, 32 new tokens; two engine
    steps fail once both hold tokens (``max_engine_errors=2``), and the
    server resurrects onto a rebuilt multi-step engine. Gates: each
    stream equals its reply, one restart, the rebuilt engine is
    multi-step and ran launches, the serving kernels launched, the leak
    check. Reports the replies' agreement with a fault-free run."""
    from paddle_tpu_torch.distributed import fault_inject as fi
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    import numpy as np
    from paddle_tpu_torch.serving.server import ServingServer, client_request
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(19)
    prompts = [torch.randint(0, V, (n,), generator=gen).tolist()
               for n in MULTI_SERVER_LENGTHS]
    ref, _ = run_multi_engine(torch, model, [np.asarray(p, np.int32)
                                             for p in prompts],
                              MULTI_SERVER_NEW, multi_step=8)
    _free_engine_memory(torch)
    fi.reset()
    reset_launch_counts()
    server = ServingServer(model, device=dev, num_slots=8,
                           page_size=PREFIX_PAGE, multi_step=8,
                           max_engine_errors=2)
    eng = server.engine
    step = eng.step

    def arming_step():
        # reads the slots without draining the launch in flight
        live = [r for r in eng._slots if r is not None]
        if not fi.get_injector().armed("engine.step") and \
                len(live) == 2 and all(r.generated for r in live):
            fi.get_injector().arm("engine.step", at_calls=(1, 2))
        return step()

    eng.step = arming_step
    port = server.start()
    replies = [None, None]
    streamed = [[], []]

    def one(i):
        replies[i] = client_request(
            "127.0.0.1", port,
            {"op": "generate", "prompt": prompts[i],
             "max_new_tokens": MULTI_SERVER_NEW, "stream": True},
            timeout_s=300, on_token=streamed[i].append)

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i, r in enumerate(replies):
            if not r or not r.get("done") or \
                    len(r["generated"]) != MULTI_SERVER_NEW or \
                    streamed[i] != r["generated"]:
                raise AssertionError(f"server_multi_step {i}: {r} "
                                     f"{streamed[i]}")
        health = client_request("127.0.0.1", port, {"op": "health"})
        leak = client_request("127.0.0.1", port, {"op": "leak_check"})
        if health.get("engine_restarts") != 1 or \
                health.get("multi_step") != 8 or \
                not health.get("macro_launches") or \
                server.engine is eng or not leak.get("ok"):
            raise AssertionError(f"server_multi_step: {health} {leak}")
        counts = serving_launch_gate("server_multi_step", launch_counts(),
                                     need=("paged_decode",
                                           "decode_out_proj",
                                           "fused_argmax"))
        emit({"phase": "server_multi_step", "ok": True, "layers":
              MULTI_LAYERS, "multi_step": 8,
              "prompt_lengths": list(MULTI_SERVER_LENGTHS),
              "engine_restarts": health["engine_restarts"],
              "macro_launches_after_restart": health["macro_launches"],
              "token_agreement_vs_fault_free": _agreement(
                  [r["generated"] for r in replies], ref),
              "launches": counts, "leak_check": leak.get("ok")})
    finally:
        server.stop()
        fi.reset()
    _free_engine_memory(torch)


# -- phase 5j: observability ops and weight hot-swap -------------------------

SWAP_PROFILE_MS = 300      # the profile op's capture window
SWAP_PROFILE_LEN = 200     # the profile wave: 8 prompts of 200 tokens,
SWAP_PROFILE_NEW = 256     # decoding long enough to outlast the window
SWAP_MULTI_N = 8
SWAP_DECODE_STEPS = 3      # profiled eager decode steps


def _seeded_state(torch, dev, config, seed):
    """Weights of ``config`` from ``seed`` as host numpy arrays
    (``checkpoint_state``), the model itself freed."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, checkpoint_state
    m = GPTForCausalLM(config, device=dev,
                       generator=torch.Generator(device=dev)
                       .manual_seed(seed))
    state = checkpoint_state(m)
    del m
    _free_engine_memory(torch)
    return state


def _server_wave(port, prompts, max_new, streamed=None):
    """The prompts as concurrent streaming generates; the generated
    tokens of each, in order (each stream must equal its reply)."""
    from paddle_tpu_torch.serving.server import client_request
    replies = [None] * len(prompts)
    streamed = streamed if streamed is not None else \
        [[] for _ in prompts]

    def one(i):
        replies[i] = client_request(
            "127.0.0.1", port,
            {"op": "generate", "prompt": [int(t) for t in prompts[i]],
             "max_new_tokens": max_new, "stream": True},
            timeout_s=600, on_token=streamed[i].append)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    return threads, replies, streamed


def _wave_tokens(phase, threads, replies, streamed, max_new):
    for t in threads:
        t.join(timeout=600)
    out = []
    for i, r in enumerate(replies):
        if not r or not r.get("done") or \
                len(r["generated"]) != max_new or \
                streamed[i] != r["generated"]:
            raise AssertionError(f"{phase} request {i}: {r}")
        out.append(r["generated"])
    return out


def _graph_capture_s(graphs):
    """Each captured iteration graph's capture seconds, by kind: a
    recapture would change them."""
    return {k: v["capture_s"] for k, v in graphs.kinds().items()}


def _profile_trace(path):
    """(bytes, kernel events, kernel names) of a chrome trace file."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return (os.path.getsize(path), len(kernels),
            sorted({e.get("name", "") for e in kernels}))


def _eager_decode_profile(torch, eng, steps):
    """Device kernel ms of one decode step of ``eng`` over ``steps``
    steady steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps


def phase_server_observe_swap(torch, dev, model, prompts, card):
    """The server's observability ops and weight hot-swap at GPT-1.3B's
    full width (8 slots, page 64, 96 pages, the prefix cache on).
    Weights A are the engine phase's seed-0 model, weights B come from
    seed 1, both held as host numpy; B is written with the port's
    ``ResilientCheckpointManager`` into a temporary directory (removed
    at the end). Steps: (1) B loaded from the checkpoint into the model
    in place, the engine phase's 8 prompts (32 new tokens) at
    ``multi_step`` 1 and 8: ``tok_B``, bitwise equal; A loaded back.
    (2) A server at ``multi_step=8`` serves the prompts (``tok_A``);
    during a wave of 8 x 200-token prompts decoding 256 tokens each a
    ``profile`` op of 300 ms, whose chrome trace must name the decode
    kernels and whose ``memory_stats`` must be the card's; ``capacity``
    (the occupancy classes sum to the pool), ``trace`` (a per-token
    timeline with macro rows, ``program_costs`` with ``prefill`` and
    ``decode_multi`` flops and bytes), ``export``, ``slo`` set and read.
    (3) ``swap`` to B at generation 1, the prompts again: bitwise
    ``tok_B``, the same captured graphs (no recapture, the same
    ``step_programs``), the serving kernels launched after the swap, 0
    hit pages for prompts cached under A. (4) A truncated shard: the
    ``swap`` op answers ``SwapFailed`` and B still serves. (5) An eager
    engine (``multi_step=1``) on A takes ``swap_weights(B)``: bitwise
    ``tok_B``; before it, on A, its ``program_costs`` decode count beside
    the device ms of a profiled decode step (and its tokens equal the
    server's ``tok_A``). The model leaves with A loaded back."""
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch.distributed.resilience import (
        ResilientCheckpointManager)
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.models.gpt import checkpoint_state, load_jax_state
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.serving.server import ServingServer, client_request
    V = model.config.vocab_size
    phase = "server_observe_swap"
    out = {"phase": phase, "card": card, "layers": model.config.num_layers,
           "prompt_lengths": [len(p) for p in prompts],
           "max_new_tokens": ENGINE_NEW}
    _free_engine_memory(torch)
    state_a = checkpoint_state(model)
    state_b = _seeded_state(torch, dev, model.config, 1)
    nbytes = sum(a.nbytes for a in state_b.values())
    ckdir = tempfile.mkdtemp(prefix="pt-swap-ckpt-")
    try:
        free = shutil.disk_usage(ckdir).free
        if free < nbytes + (1 << 30):
            raise AssertionError(f"{phase}: {free} bytes free under "
                                 f"{ckdir}, the checkpoint needs {nbytes}")
        t0 = time.monotonic()
        ResilientCheckpointManager(ckdir).save(1, state_b)
        out["checkpoint_bytes"] = nbytes
        out["checkpoint_save_s"] = time.monotonic() - t0
        del state_b
        t0 = time.monotonic()
        got = ResilientCheckpointManager(ckdir).restore_latest_valid()
        out["checkpoint_load_s"] = time.monotonic() - t0
        if got is None or got[0] != 1:
            raise AssertionError(f"{phase}: the checkpoint did not restore")
        state_b = got[1]

        # (1) the reference tokens on B
        load_jax_state(model, state_b)
        tok_b, _ = run_multi_engine(torch, model, prompts, ENGINE_NEW,
                                    multi_step=1)
        _free_engine_memory(torch)
        tok_b8, _ = run_multi_engine(torch, model, prompts, ENGINE_NEW,
                                     multi_step=SWAP_MULTI_N)
        _free_engine_memory(torch)
        _generation_ok(phase, tok_b, ENGINE_NEW, V)
        check_tokens(f"{phase} tok_B N=8 vs N=1", tok_b8, tok_b)
        load_jax_state(model, state_a)

        # (2) serve A and read every observability op
        server = ServingServer(model, device=dev, num_slots=8,
                               page_size=PREFIX_PAGE, num_pages=96,
                               multi_step=SWAP_MULTI_N)
        port = server.start()
        try:
            tok_a = _wave_tokens(phase, *_server_wave(port, prompts,
                                                      ENGINE_NEW),
                                 ENGINE_NEW)
            out["tokens_agree_a_vs_b"] = _agreement(tok_a, tok_b)
            if tok_a == tok_b:
                # the swap would be unobservable
                raise AssertionError(f"{phase}: weights A and B give the "
                                     f"same tokens")
            gen = torch.Generator().manual_seed(23)
            wave = [torch.randint(0, V, (SWAP_PROFILE_LEN,),
                                  generator=gen).numpy()
                    for _ in range(8)]
            threads, replies, streamed = _server_wave(port, wave,
                                                      SWAP_PROFILE_NEW)
            # two launches drained: every slot is decoding
            t_wait = time.monotonic() + 300
            while not all(len(s) >= 2 * SWAP_MULTI_N for s in streamed):
                if time.monotonic() > t_wait:
                    raise AssertionError(f"{phase}: the profile wave did "
                                         f"not start decoding")
                time.sleep(0.005)
            prof_dir = tempfile.mkdtemp(prefix="pt-swap-profile-")
            try:
                prof = client_request("127.0.0.1", port,
                                      {"op": "profile",
                                       "ms": SWAP_PROFILE_MS,
                                       "dir": prof_dir}, timeout_s=600)
                left = min(len(s) for s in streamed)
                _wave_tokens(phase, threads, replies, streamed,
                             SWAP_PROFILE_NEW)
                if "error" in prof:
                    raise AssertionError(f"{phase} profile: {prof}")
                size, n_kernels, names = _profile_trace(prof["trace_file"])
            finally:
                shutil.rmtree(prof_dir, ignore_errors=True)
            mem = prof["devices"][0]["memory_stats"]
            named = {k: any(k in nm for nm in names)
                     for k in GRAPH_KERNEL_NAMES}
            if prof.get("chip_pending") is not False or not mem or \
                    not all(named.values()):
                raise AssertionError(f"{phase} profile: chip_pending "
                                     f"{prof.get('chip_pending')}, "
                                     f"kernels named {named} of "
                                     f"{n_kernels} events {names[:12]}")
            out["profile"] = {
                "ms": SWAP_PROFILE_MS, "trace_bytes": size,
                "kernel_events": n_kernels, "kernels_named": named,
                "tokens_streamed_at_start": left,
                "allocated_bytes": mem.get("allocated_bytes.all.current"),
                "device_free_bytes": mem.get("device_free_bytes")}
            cap = client_request("127.0.0.1", port,
                                 {"op": "capacity", "ledger_tail": 8})
            occ = cap["occupancy"]
            if sum(occ.values()) != cap["num_pages"] or \
                    not cap.get("ledger_tail"):
                raise AssertionError(f"{phase} capacity: {cap}")
            tr = client_request("127.0.0.1", port, {"op": "trace", "n": 4})
            macro_rows = sum("macro_launch" in r
                             for r in tr["per_token_timeline"])
            costs = tr["program_costs"]
            if not macro_rows or any(
                    not (costs.get(k, {}).get("flops", 0) > 0
                         and costs[k].get("bytes_accessed", 0) > 0)
                    for k in ("prefill", "decode_multi")):
                raise AssertionError(f"{phase} trace: {macro_rows} macro "
                                     f"rows, program_costs {costs}")
            exp = client_request("127.0.0.1", port, {"op": "export"})
            slo_set = client_request("127.0.0.1", port,
                                     {"op": "slo", "ttft_ms": 5000,
                                      "tpot_ms": 200})
            slo = client_request("127.0.0.1", port, {"op": "slo"})
            if "export" not in exp or slo["slo"]["ttft_ms"] != 5000 or \
                    slo["slo"]["tpot_ms"] != 200 or "error" in slo_set:
                raise AssertionError(f"{phase} export/slo: {slo}")
            out.update(capacity={"occupancy": occ,
                                 "forecast": cap["forecast"]},
                       per_token_rows=len(tr["per_token_timeline"]),
                       macro_rows=macro_rows, program_costs=costs)

            # (3) swap to B: the same graphs replay the new weights
            eng = server.engine
            graphs = eng._macro["graphs"]
            kinds = _graph_capture_s(graphs)
            step_programs = dict(eng.step_programs)
            pc = server.prefix_cache
            cached_before = pc.total_pages()
            t0 = time.monotonic()
            rep = client_request("127.0.0.1", port,
                                 {"op": "swap", "checkpoint": ckdir,
                                  "generation": 1}, timeout_s=900)
            out["swap_op_s"] = time.monotonic() - t0
            if rep.get("generation") != 1:
                raise AssertionError(f"{phase} swap: {rep}")
            out["swap_ms"] = rep["swap_ms"]
            hits = pc.hit_pages
            reset_launch_counts()
            tok_s = _wave_tokens(phase, *_server_wave(port, prompts,
                                                      ENGINE_NEW),
                                 ENGINE_NEW)
            out["launches_after_swap"] = serving_launch_gate(
                f"{phase} after swap", launch_counts())
            check_tokens(f"{phase} swapped server N=8 vs tok_B", tok_s,
                         tok_b)
            now = _graph_capture_s(graphs)
            if server.engine is not eng or eng._macro["graphs"] is not \
                    graphs or now != kinds or \
                    dict(eng.step_programs) != step_programs:
                raise AssertionError(f"{phase}: graphs recaptured "
                                     f"({kinds} -> {now})")
            if pc.hit_pages != hits or not cached_before:
                raise AssertionError(f"{phase}: {pc.hit_pages - hits} hit "
                                     f"pages after the swap "
                                     f"({cached_before} cached under A)")
            out.update(cached_pages_under_a=cached_before,
                       hit_pages_after_swap=pc.hit_pages - hits,
                       graphs_kept=kinds)

            # (4) a torn shard is refused typed; B keeps serving
            step_dir = os.path.join(ckdir, "step_00000001")
            shard = os.path.join(step_dir, sorted(
                f for f in os.listdir(step_dir) if f.endswith(".npy"))[0])
            with open(shard, "r+b") as f:
                f.truncate(os.path.getsize(shard) // 2)
            bad = client_request("127.0.0.1", port,
                                 {"op": "swap", "checkpoint": ckdir,
                                  "generation": 2}, timeout_s=900)
            health = client_request("127.0.0.1", port, {"op": "health"})
            after = _wave_tokens(phase, *_server_wave(port, prompts[:1],
                                                      ENGINE_NEW),
                                 ENGINE_NEW)
            if bad.get("error") != "SwapFailed" or \
                    health["weight_generation"] != 1:
                raise AssertionError(f"{phase} corrupt swap: {bad} "
                                     f"{health}")
            check_tokens(f"{phase} after the refused swap", after,
                         tok_b[:1])
            out["corrupt_swap"] = bad
            leak = client_request("127.0.0.1", port, {"op": "leak_check"})
            if not leak.get("ok"):
                raise AssertionError(f"{phase} leak_check: {leak}")
        finally:
            server.stop()
        _free_engine_memory(torch)

        # (5) the eager engine swaps A -> B; its decode count beside a
        # profiled step of the A run (the count is the first decode's)
        load_jax_state(model, state_a)
        eng = create_decode_engine(model, device=dev, num_slots=8,
                                   page_size=PREFIX_PAGE, num_pages=96,
                                   capture_costs=True)
        rids = [eng.submit(p, max_new_tokens=ENGINE_NEW) for p in prompts]
        for _ in range(2):
            eng.step()
        decode_ms = _eager_decode_profile(torch, eng, SWAP_DECODE_STEPS)
        res = eng.run()
        check_tokens(f"{phase} eager engine on A vs the server",
                     [res[r][len(p):].tolist()
                      for r, p in zip(rids, prompts)], tok_a)
        cost = eng.program_costs()["decode"]
        info = eng.swap_weights(state_b, generation=1)
        rids = [eng.submit(p, max_new_tokens=ENGINE_NEW) for p in prompts]
        res = eng.run()
        tok_e = [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]
        check_tokens(f"{phase} eager swap_weights vs tok_B", tok_e, tok_b)
        eng.close()
        # the model leaves with the engine phase's weights A, which the
        # generate phase reads
        load_jax_state(model, state_a)
        bound, by = bound_ms(cost["bytes_accessed"], cost["flops"])
        out["eager"] = {"swap_ms": info["swap_ms"],
                        "decode_cost": cost,
                        "decode_device_ms": decode_ms,
                        "decode_bound_ms": bound, "bound_by": by,
                        "bound_share": bound / decode_ms}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    emit(dict(out, ok=True))
    _free_engine_memory(torch)


# -- the fleet ---------------------------------------------------------------

FLEET_MODEL = "gpt_1p3b"
FLEET_SERVER_ARGS = ("--num-slots", "8", "--page-size", "64",
                     "--num-pages", "96", "--slo-ttft-ms", "5000",
                     "--slo-tpot-ms", "200")
# the decode replica lands a whole chain in its host tier before the
# admission restores it (one fp32 page blob of GPT-1.3B is 25.2 MB, a
# 1600-token prompt's chain 24 pages), and the prefill replica parks the
# chains the device tier evicts there: room for every chain of the wave
FLEET_SPILL_MB = 4096
# the wave's shortest and longest prompts (the 1200 and 1400 ones were
# cut to keep the script's clock, ~35 s of handoffs)
FLEET_HANDOFF_LENGTHS = (1024, 1600)
FLEET_NEW = 32
FLEET_PROFILE_MS = 300
FLEET_STALL_PAGES = 4           # pages exported while the stall is read
FLEET_BYTES_LEN = 260           # the in-process pair's prompt: 4 pages
FLEET_FAILOVER_LEN = 200
FLEET_FAILOVER_NEW = 256
FLEET_FAILOVER_KILL_AT = 8      # streamed tokens before the kill
FLEET_FRESH_LENGTHS = (300, 700)
FLEET_ROLL_NEW = 16
FLEET_CANARY_S = 2.0
FLEET_KERNELS = {"decode": ("paged_decode_kernel", "out_proj_kernel",
                            "argmax_tiles_kernel"),
                 "prefill": ("attention_fwd_kernel",
                             "argmax_tiles_kernel")}


def _kernel_event_counts(path, symbols):
    """Kernel events of a chrome trace by symbol substring."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {s: sum(s in n for n in names) for s in symbols}, len(names)


def _top2_gap(torch, model, prompt, want, got):
    """At the first position where ``got`` leaves ``want``: the position
    and the in-process model's gap between its two largest logits
    there."""
    i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    ids = torch.tensor([list(prompt) + list(want[:i])],
                       device=model.device)
    with torch.no_grad():
        out = model(ids)
    logits = (out[0] if isinstance(out, tuple) else out)[0, -1].float()
    top = torch.topk(logits, 2).values
    return {"position": i, "top2_gap": float(top[0] - top[1])}


def _fleet_tokens(torch, model, name, got, want, prompts):
    """``check_tokens`` of the fleet against the in-process engine, with
    the first divergence's top-2 logit gap of each request that left it."""
    check_tokens(name, got, want)
    if got != want:
        emit({"check": name, "divergence": [
            _top2_gap(torch, model, p, w, g)
            for p, w, g in zip(prompts, want, got) if w != g]})


def _alone(torch, model, prompts, max_new):
    """Each prompt through its own in-process engine, alone (the fleet's
    engine configuration), as each request reaches a replica."""
    out = []
    for p in prompts:
        toks, _ = run_multi_engine(torch, model, [p], max_new,
                                   multi_step=1)
        out.append(toks[0])
        _free_engine_memory(torch)
    return out


def _start_fleet(roles, extra=()):
    from paddle_tpu_torch.serving.supervisor import (FailoverRouter,
                                                     Supervisor)
    env = {"PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                           "")}
    sup = Supervisor(model=FLEET_MODEL, replicas=len(roles), roles=roles,
                     server_args=list(FLEET_SERVER_ARGS)
                     + ["--spill-mb", str(FLEET_SPILL_MB)] + list(extra),
                     replica_env=env, probe_interval_s=0.25,
                     ready_timeout_s=600,
                     log_dir=os.path.join(HERE, "build", "fleet-logs"))
    t0 = time.monotonic()
    router = None
    try:
        sup.start(wait_ready=True)
        boot_s = time.monotonic() - t0
        router = FailoverRouter(sup)
        router.start()
    except BaseException:
        if router is not None:
            router.stop()
        sup.stop()
        raise
    return sup, router, boot_s


def _stop_fleet(sup, router):
    try:
        router.stop()
    finally:
        sup.stop()


def _rpc(port, payload, timeout_s=600):
    from paddle_tpu_torch.serving.server import client_request
    return client_request("127.0.0.1", port, payload, timeout_s=timeout_s)


def _routed(port, prompt, max_new, key=None, on_token=None, timeout_s=600):
    """One streaming generate through the router: (reply, streamed
    tokens, client ms to the first token, client ms a later token)."""
    from paddle_tpu_torch.serving.server import client_request
    streamed, stamps = [], []

    def tok(t):
        stamps.append(time.monotonic())
        streamed.append(t)
        if on_token is not None:
            on_token(len(streamed))

    msg = {"op": "generate", "prompt": [int(t) for t in prompt],
           "max_new_tokens": max_new, "stream": True}
    if key is not None:
        msg["key"] = key
    t0 = time.monotonic()
    reply = client_request("127.0.0.1", port, msg, timeout_s=timeout_s,
                           on_token=tok)
    ttft = (stamps[0] - t0) * 1e3 if stamps else None
    tpot = ((stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
            if len(stamps) > 1 else None)
    return reply, streamed, ttft, tpot


def _counter(port, name):
    return _rpc(port, {"op": "stats"})["stats"]["counters"].get(name, 0)


def _profile_in_thread(port, ms, prof_dir, sink, key):
    def run():
        sink[key] = _rpc(port, {"op": "profile", "ms": ms,
                                "dir": prof_dir})
    t = threading.Thread(target=run)
    t.start()
    return t


def fleet_handoff_bytes(torch, dev, model, prompt):
    """An in-process prefill / decode ServingServer pair on ``model``:
    one handoff of ``prompt``, then each restored page of the decode
    server, read from its pool, packed and compared byte for byte with
    the blob the prefill server exported."""
    from paddle_tpu_torch.serving.prefix_cache import pack_page_blob
    from paddle_tpu_torch.serving.server import (ServingServer,
                                                 client_request,
                                                 fetch_page_blobs)
    kw = dict(device=dev, num_slots=8, page_size=PREFIX_PAGE,
              num_pages=96, spill_bytes=FLEET_SPILL_MB << 20)
    pf = ServingServer(model, role="prefill", **kw)
    dec = ServingServer(model, role="decode", **kw)
    try:
        pf.start()
        dec.start()
        ack = client_request("127.0.0.1", pf.port,
                             {"op": "generate", "prompt": prompt,
                              "max_new_tokens": 1, "prefill_only": True},
                             timeout_s=600)
        out = client_request("127.0.0.1", dec.port,
                             {"op": "generate", "prompt": prompt,
                              "max_new_tokens": FLEET_NEW,
                              "fetch_from": {"host": "127.0.0.1",
                                             "port": pf.port}},
                             timeout_s=600)
        keys = [bytes.fromhex(k) for k in ack.get("keys", ())]
        blobs, missing, _ = fetch_page_blobs("127.0.0.1", pf.port,
                                             keys=keys)
        if missing or out.get("stats", {}).get("handoff_pages") != \
                len(keys) or not keys:
            raise AssertionError(f"fleet byte check: ack {ack.get('keys')}"
                                 f" missing {missing} reply {out}")
        pc = dec.prefix_cache
        equal = 0
        for k in keys:
            page = pc._entries[k].page
            got = pack_page_blob(pc._read_page(page),
                                 fmt=pc.blob_format)
            equal += got == blobs[k]
        return {"pages": len(keys), "byte_equal_pages": equal,
                "tokens": out["generated"]}
    finally:
        dec.stop()
        pf.stop()
        _free_engine_memory(torch)


def phase_fleet(torch, dev, model, card):
    """The fleet on one card at GPT-1.3B's full width: replicas are
    ``python -m paddle_tpu_torch.serving.server`` processes (seed-0
    weights, 8 slots, page 64, 96 pages, fp32) under a ``Supervisor``,
    fronted by a ``FailoverRouter`` in this process.
    (1) Roles prefill + decode: 2 keyed prompts of 1024 and 1600 tokens, 32
    new tokens each, one at a time: each runs prefill_only on replica 0
    and decodes on replica 1 with a fetch_from hint. Held: 2 handoffs,
    each request's handoff pages = its chain, restored = handoff pages,
    no handoff failure, leak_check on both. Printed: handoff ms, bytes,
    TTFT and TPOT at the client, the token agreement with the in-process
    engine, the prefill replica's engine stall during an export (the
    latency of a leak_check sent while a chain is exported), each
    replica's memory and the card's. (2) A profile window on each
    replica during the first request: the decode kernels in the decode
    replica's trace, attention_fwd in the prefill replica's. One request
    again on an int8-blob pair. In this process, an in-process pair holds
    the restored pages byte-equal to the exported blobs. (3) Two mixed
    replicas: a keyed stream of 256 tokens, its replica killed after 8
    tokens; the stream completes on the survivor equal to the in-process
    engine's tokens, the killed replica respawns; fresh prompts equal the
    in-process engine's. (4) ``roll_fleet`` onto a seed-1 checkpoint
    (canary 2 s) while a client streams: both replicas at generation 1,
    no failed request, a fresh prompt equal to the in-process engine on
    seed-1 weights. (5) ``fleet_stats`` and ``fleet_capacity`` through
    the router."""
    import shutil
    import tempfile
    from paddle_tpu_torch.distributed.resilience import (
        ResilientCheckpointManager)
    from paddle_tpu_torch.models.gpt import checkpoint_state, load_jax_state
    from paddle_tpu_torch.serving.prefix_cache import PrefixCache
    phase = "fleet"
    V = model.config.vocab_size
    out = {"phase": phase, "card": card, "model": FLEET_MODEL,
           "server_args": list(FLEET_SERVER_ARGS),
           "spill_mb": FLEET_SPILL_MB}
    gen = torch.Generator().manual_seed(31)
    hand = [torch.randint(0, V, (n,), generator=gen).tolist()
            for n in FLEET_HANDOFF_LENGTHS]
    fresh = [torch.randint(0, V, (n,), generator=gen).tolist()
             for n in FLEET_FRESH_LENGTHS]
    fo_prompt = torch.randint(0, V, (FLEET_FAILOVER_LEN,),
                              generator=gen).tolist()
    _free_engine_memory(torch)
    ref_hand = _alone(torch, model, hand, FLEET_NEW)
    ref_fresh = _alone(torch, model, fresh, FLEET_NEW)
    ref_fo = _alone(torch, model, [fo_prompt], FLEET_FAILOVER_NEW)[0]
    byte_check = fleet_handoff_bytes(torch, dev, model,
                                     hand[0][:FLEET_BYTES_LEN])
    if byte_check["byte_equal_pages"] != byte_check["pages"]:
        FAILED_CHECKS.append(f"{phase}: restored pages not byte-equal to "
                             f"the exported blobs {byte_check}")
    out["in_process_handoff"] = {
        "pages": byte_check["pages"],
        "byte_equal_pages": byte_check["byte_equal_pages"],
        "token_agreement_vs_local": _agreement(
            [byte_check["tokens"]],
            _alone(torch, model, [hand[0][:FLEET_BYTES_LEN]],
                   FLEET_NEW))}
    state_a = checkpoint_state(model)
    state_b = _seeded_state(torch, dev, model.config, 1)
    load_jax_state(model, state_b)
    ref_b = _alone(torch, model, fresh[:1], FLEET_NEW)
    load_jax_state(model, state_a)
    del state_a
    ckdir = os.path.join(HERE, "build", "fleet-ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.monotonic()
    ResilientCheckpointManager(ckdir).save(1, state_b)
    out["checkpoint_save_s"] = time.monotonic() - t0
    del state_b
    prof_dir = tempfile.mkdtemp(prefix="pt-fleet-profile-",
                                dir=os.path.join(HERE, "build"))
    try:
        # (1) + (2): prefill -> decode handoff, kernels in the replicas
        sup, router, boot_s = _start_fleet(["prefill", "decode"])
        try:
            pf, dec = sup.replicas
            out["boot_s"] = boot_s
            reqs, toks, profs = [], [], {}
            for i, prompt in enumerate(hand):
                threads = []
                if i == 0:
                    threads.append(_profile_in_thread(
                        pf.port, FLEET_PROFILE_MS, prof_dir, profs,
                        "prefill"))
                    time.sleep(0.05)

                def on_token(n, i=i):
                    if i == 0 and n == 2:
                        threads.append(_profile_in_thread(
                            dec.port, FLEET_PROFILE_MS, prof_dir, profs,
                            "decode"))

                before = _counter(dec.port, "handoff_bytes_total")
                reply, streamed, ttft, tpot = _routed(
                    router.port, prompt, FLEET_NEW, key=f"h{i}",
                    on_token=on_token)
                for t in threads:
                    t.join(timeout=600)
                st = reply.get("stats", {})
                chain = (len(prompt) - 1) // PREFIX_PAGE
                if not reply.get("done") or streamed != \
                        reply.get("generated") or \
                        st.get("handoff_pages") != chain or \
                        st.get("restored_pages") != chain:
                    raise AssertionError(f"{phase} handoff {i}: chain "
                                         f"{chain}, {st} {reply.get('error')}"
                                         f" {reply.get('reason')}")
                toks.append(reply["generated"])
                reqs.append({
                    "prompt_len": len(prompt), "chain_pages": chain,
                    "handoff_pages": st["handoff_pages"],
                    "restored_pages": st["restored_pages"],
                    "handoff_ms": st.get("handoff_ms"),
                    "handoff_bytes": _counter(
                        dec.port, "handoff_bytes_total") - before,
                    "client_ttft_ms": ttft, "client_tpot_ms": tpot,
                    "replica_ttft_s": st.get("ttft_s"),
                    "replica_tpot_s": st.get("tpot_s")})
            h = _rpc(router.port, {"op": "health"})
            fails = _counter(dec.port, "handoff_failures_total")
            leaks = [_rpc(r.port, {"op": "leak_check"}) for r in
                     (pf, dec)]
            if h["handoffs_total"] != len(hand) or fails or \
                    h["handoff_prefill_failures_total"] or \
                    not all(lk.get("ok") for lk in leaks):
                raise AssertionError(f"{phase}: handoffs "
                                     f"{h['handoffs_total']}, failures "
                                     f"{fails}, leak_check {leaks}")
            out["handoff"] = {
                "requests": reqs,
                "token_agreement_vs_in_process": _agreement(toks,
                                                            ref_hand)}
            # the prefill replica's engine stall while it exports the
            # first pages of the last prompt's (device-resident) chain
            keys = [k.hex() for k in PrefixCache(PREFIX_PAGE)
                    .chain_keys_for(hand[-1])][:FLEET_STALL_PAGES]
            stall = {}

            def fetch():
                t = time.monotonic()
                rep = _rpc(pf.port, {"op": "fetch_pages", "keys": keys})
                stall["fetch_ms"] = (time.monotonic() - t) * 1e3
                stall["pages"] = rep.get("count")
                stall["bytes"] = rep.get("bytes")

            th = threading.Thread(target=fetch)
            th.start()
            time.sleep(0.005)
            t = time.monotonic()
            _rpc(pf.port, {"op": "leak_check"})
            stall["leak_check_ms"] = (time.monotonic() - t) * 1e3
            th.join(timeout=600)
            out["export_stall"] = stall
            kern = {}
            for role in ("prefill", "decode"):
                prof = profs.get(role) or {}
                if "trace_file" not in prof:
                    raise AssertionError(f"{phase} {role} profile: {prof}")
                counts, n = _kernel_event_counts(prof["trace_file"],
                                                 FLEET_KERNELS[role])
                mem = prof["devices"][0]["memory_stats"] or {}
                kern[role] = {"kernel_events": n, "counts": counts,
                              "allocated_bytes":
                                  mem.get("allocated_bytes.all.current"),
                              "reserved_bytes":
                                  mem.get("reserved_bytes.all.current")}
                if not all(counts.values()):
                    raise AssertionError(f"{phase}: the {role} replica's "
                                         f"trace lacks kernels {counts}")
            free, total = torch.cuda.mem_get_info()
            out["replicas"] = kern
            out["card_memory_used_bytes"] = total - free
            fs = _rpc(router.port, {"op": "fleet_stats"})["fleet"]
            fc = _rpc(router.port, {"op": "fleet_capacity"})["capacity"]
            out["fleet_stats"] = {"slo": fs.get("slo"),
                                  "pressure": fs.get("pressure"),
                                  "router": fs.get("router")}
            out["fleet_capacity"] = {k: fc[k] for k in (
                "replicas_fresh", "num_pages", "occupancy",
                "used_fraction", "tte_s")}
        finally:
            _stop_fleet(sup, router)
        sup, router, boot_s = _start_fleet(["prefill", "decode"],
                                           ("--blob-format", "int8"))
        try:
            dec = sup.replicas[1]
            before = _counter(dec.port, "handoff_bytes_total")
            reply, streamed, ttft, _ = _routed(router.port, hand[0],
                                               FLEET_NEW, key="i8")
            st = reply.get("stats", {})
            chain = (len(hand[0]) - 1) // PREFIX_PAGE
            if st.get("handoff_pages") != chain or \
                    streamed != reply.get("generated"):
                raise AssertionError(f"{phase} int8 handoff: {st}")
            out["handoff_int8"] = {
                "boot_s": boot_s, "handoff_pages": st["handoff_pages"],
                "handoff_ms": st.get("handoff_ms"),
                "handoff_bytes": _counter(
                    dec.port, "handoff_bytes_total") - before,
                "client_ttft_ms": ttft,
                "token_agreement_vs_in_process": _agreement(
                    [reply["generated"]], ref_hand[:1])}
        finally:
            _stop_fleet(sup, router)

        # (3) failover and respawn on two mixed replicas
        sup, router, boot_s = _start_fleet(["mixed", "mixed"])
        try:
            out["mixed_boot_s"] = boot_s
            killed = {}

            def kill(n):
                if n == FLEET_FAILOVER_KILL_AT:
                    for rep in sup.replicas:
                        if _rpc(rep.port, {"op": "health"})["active"]:
                            killed["idx"] = rep.idx
                            killed["t"] = time.monotonic()
                            sup.kill_replica(rep.idx)
                            return

            reply, streamed, _, _ = _routed(
                router.port, fo_prompt, FLEET_FAILOVER_NEW, key="fo",
                on_token=kill)
            h = _rpc(router.port, {"op": "health"})
            if "idx" not in killed or not reply.get("done") or \
                    h["failovers_total"] < 1:
                raise AssertionError(f"{phase} failover: killed {killed},"
                                     f" {reply.get('error')} "
                                     f"{reply.get('reason')}, health {h}")
            _fleet_tokens(torch, model, f"{phase} failover stream",
                          [streamed, reply["generated"]],
                          [ref_fo, ref_fo], [fo_prompt, fo_prompt])
            rep = next(r for r in sup.replicas if r.idx == killed["idx"])
            t_end = time.monotonic() + 600
            while not (rep.ready and rep.alive() and rep.restarts == 1):
                if time.monotonic() > t_end:
                    raise AssertionError(f"{phase}: replica {rep.idx} did "
                                         f"not respawn")
                time.sleep(0.05)
            out["failover"] = {
                "killed_replica": killed["idx"],
                "failovers_total": h["failovers_total"],
                "restarts_total": sup.restarts_total,
                "respawn_to_ready_s": time.monotonic() - killed["t"],
                "streamed": len(streamed)}
            if sup.restarts_total != 1:
                raise AssertionError(f"{phase}: restarts_total "
                                     f"{sup.restarts_total}")
            got = [_routed(router.port, p, FLEET_NEW)[0]["generated"]
                   for p in fresh]
            _fleet_tokens(torch, model, f"{phase} fresh prompts vs the "
                          f"in-process engine", got, ref_fresh, fresh)

            # (4) roll onto seed-1 weights while a client streams
            stop, during = threading.Event(), []

            def client():
                j = 0
                while not stop.is_set():
                    r, s, _, _ = _routed(router.port, fresh[j % 2],
                                         FLEET_ROLL_NEW, key=f"r{j}")
                    during.append(bool(r.get("done")) and
                                  s == r.get("generated") and
                                  len(s) == FLEET_ROLL_NEW)
                    j += 1

            th = threading.Thread(target=client)
            th.start()
            t0 = time.monotonic()
            try:
                roll = sup.roll_fleet(ckdir, canary_window_s=FLEET_CANARY_S)
            finally:
                roll_s = time.monotonic() - t0
                stop.set()
                th.join(timeout=600)
            gens = [_rpc(r.port, {"op": "health"})["weight_generation"]
                    for r in sup.replicas]
            pauses = [_rpc(r.port, {"op": "stats"})["stats"]["swap_ms"]
                      for r in sup.replicas]
            if not roll.get("ok") or gens != [1, 1] or not during or \
                    not all(during):
                raise AssertionError(f"{phase} roll: {roll}, generations "
                                     f"{gens}, requests {during}")
            got_b = [_routed(router.port, p, FLEET_NEW)[0]["generated"]
                     for p in fresh[:1]]
            _fleet_tokens(torch, model, f"{phase} after the roll vs seed-1 "
                          f"weights", got_b, ref_b, fresh[:1])
            out["roll"] = {"wall_s": roll_s, "swapped": roll["swapped"],
                           "canary": roll["canary"],
                           "requests_during": len(during),
                           "swap_ms": pauses}
            fs = _rpc(router.port, {"op": "fleet_stats"})["fleet"]
            out["fleet_stats_mixed"] = {
                "restarts_total": fs["restarts_total"],
                "weight_generations": fs["weight_generations"],
                "router": fs["router"]}
        finally:
            _stop_fleet(sup, router)
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
        shutil.rmtree(ckdir, ignore_errors=True)
    emit(dict(out, ok=True))
    _free_engine_memory(torch)

# -- the autoscaler, its journal and the chaos harness on the card ----------

FA_LENGTHS = (130, 150, 170, 190)   # (a)'s keyed prompts: 2-3 pages of 64
FA_NEW = 16
FA_PROFILE_LEN = 190                # the spawned replica's profiled stream:
FA_PROFILE_NEW = 64                 # a prompt no other replica holds
FA_PROFILE_MS = 300
# (a)'s replicas: FLEET_SERVER_ARGS and a host tier for the scale-down's
# handoff to land in (a mixed replica has none by default)
FA_SPILL_MB = 512
FA_CHAOS_REQUESTS = 6
FA_CHAOS_LENGTHS = (130, 191)       # rng.integers(lo, hi): 2-3 pages
FA_CHAOS_MAX_SEQ = 256
FA_CHAOS_PAGE = 64
FA_DEVICE = "cuda"                  # the chaos replicas' --device
FA_APPS_EVERY_S = 1.0


def _proc_cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode("utf-8", "replace")
    except OSError:
        return ""


def _proc_kind(pid):
    """This script, one of the port's replicas or supervisors, or None."""
    if pid == os.getpid():
        return "smoke"
    cmd = _proc_cmdline(pid)
    for mod, kind in (("paddle_tpu_torch.serving.server", "replica"),
                      ("paddle_tpu_torch.serving.supervisor",
                       "supervisor")):
        if mod in cmd:
            return kind
    return None


def _device_fds(pid):
    """Open files of ``pid`` on ``/dev/nvidia*``: a process that created
    a CUDA context holds the card's device files open."""
    n = 0
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return 0
    for fd in fds:
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                "/dev/nvidia")
        except OSError:
            pass
    return n


class _CardApps:
    """Every ``FA_APPS_EVERY_S`` seconds on a thread: this script and the
    port's replica and supervisor processes, each with its largest count
    of open ``/dev/nvidia*`` files (a CUDA context) and, for a replica,
    its largest reserved bytes (the ``profile`` op without a window);
    the card's largest used bytes; the rows of ``nvidia-smi
    --query-compute-apps=pid,used_memory``."""

    def __init__(self, torch):
        self.torch = torch
        self.seen = {}
        self.smi_rows = set()
        self.card_max_bytes = 0
        self.samples = 0
        self.errors = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def sample(self):
        try:
            r = subprocess.run(["nvidia-smi",
                                "--query-compute-apps=pid,used_memory",
                                "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30)
            self.smi_rows.update(x.strip() for x in r.stdout.splitlines()
                                 if x.strip())
        except (OSError, subprocess.SubprocessError):
            pass
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            pid = int(name)
            kind = _proc_kind(pid)
            if kind is None:
                continue
            ent = self.seen.setdefault(pid, {"kind": kind, "device_fds": 0,
                                             "max_reserved_bytes": None})
            ent["device_fds"] = max(ent["device_fds"], _device_fds(pid))
            toks = _proc_cmdline(pid).split()
            if kind == "replica" and "--port" in toks:
                try:
                    port = int(toks[toks.index("--port") + 1])
                    mem = _rpc(port, {"op": "profile"}, timeout_s=3)[
                        "devices"][0]["memory_stats"] or {}
                    got = mem.get("reserved_bytes.all.current")
                    if got is not None:
                        ent["max_reserved_bytes"] = max(
                            ent["max_reserved_bytes"] or 0, got)
                except (OSError, ValueError, KeyError, IndexError):
                    pass  # booting, or gone
        free, total = self.torch.cuda.mem_get_info()
        self.card_max_bytes = max(self.card_max_bytes, total - free)
        self.samples += 1

    def _run(self):
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception as e:  # the sampler must outlive a bad read
                self.errors.append(f"{type(e).__name__}: {e}")
            self._stop.wait(FA_APPS_EVERY_S)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=60)
        return {"samples": self.samples, "errors": self.errors[:4],
                "card_max_used_bytes": self.card_max_bytes,
                "nvidia_smi_rows": sorted(self.smi_rows),
                "processes": {str(p): v
                              for p, v in sorted(self.seen.items())}}

    @staticmethod
    def failures(rec):
        """A supervisor process that held the card's device files open,
        or a run in which the method saw no context at all."""
        procs = rec["processes"].values()
        sups = [p for p in procs if p["kind"] == "supervisor"]
        bad = [p for p in sups if p["device_fds"]]
        if bad or not sups or not any(
                p["device_fds"] for p in procs if p["kind"] == "replica"):
            return {"supervisors": sups, "with_device_files": bad}
        return None


def fleet_autoscale_live(torch, model, root):
    """(a): a ``Supervisor`` + ``Autoscaler`` + ``FailoverRouter`` in this
    process on one replica; 4 keyed prompts served, a forced scale-up,
    served again (and a profiled stream on the spawned replica), a forced
    scale-down, served again."""
    from paddle_tpu_torch.serving.autoscaler import (AutoscaleConfig,
                                                     Autoscaler)
    from paddle_tpu_torch.serving.supervisor import (FailoverRouter,
                                                     Supervisor)
    from paddle_tpu_torch.tools.flight_inspect import lint_fleet_journal
    phase = "fleet_autoscale"
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(41)
    prompts = [torch.randint(0, V, (n,), generator=gen).tolist()
               for n in FA_LENGTHS]
    own = torch.randint(0, V, (FA_PROFILE_LEN,), generator=gen).tolist()
    ref = _alone(torch, model, prompts, FA_NEW)
    ref_own = _alone(torch, model, [own], FA_PROFILE_NEW)[0]
    journal = os.path.join(root, "fleet-journal.json")
    prof_dir = os.path.join(root, "profile")
    os.makedirs(prof_dir, exist_ok=True)
    env = {"PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                           "")}
    sup = Supervisor(model=FLEET_MODEL, replicas=1,
                     server_args=list(FLEET_SERVER_ARGS)
                     + ["--spill-mb", str(FA_SPILL_MB)],
                     replica_env=env, probe_interval_s=0.25,
                     ready_timeout_s=600,
                     log_dir=os.path.join(root, "logs"))
    asc = Autoscaler(sup, AutoscaleConfig(min_replicas=1, max_replicas=2,
                                          cooldown_up_s=0.0,
                                          cooldown_down_s=0.0,
                                          spawn_ready_timeout_s=600.0),
                     journal_path=journal)
    drains = []
    drain_replica = sup.drain_replica

    def recorded_drain(*a, **kw):
        drains.append(drain_replica(*a, **kw))
        return drains[-1]

    sup.drain_replica = recorded_drain
    out = {}
    router = None
    try:
        t0 = time.monotonic()
        sup.start(wait_ready=True)
        out["boot_to_ready_s"] = time.monotonic() - t0
        router = FailoverRouter(sup)
        router.start()

        def wave(label):
            got = []
            for i, p in enumerate(prompts):
                reply, streamed, _, _ = _routed(router.port, p, FA_NEW,
                                                key=f"as{i}")
                if not reply.get("done") or \
                        streamed != reply.get("generated"):
                    raise AssertionError(f"{phase} {label} {i}: "
                                         f"{reply.get('error')} "
                                         f"{reply.get('reason')}")
                got.append(reply["generated"])
            _fleet_tokens(torch, model, f"{phase} {label} vs the "
                          f"in-process engine", got, ref, prompts)

        wave("before the scale-up")
        t0 = time.monotonic()
        up = asc.scale_up(reason="smoke", force=True)
        out["scale_up_s"] = time.monotonic() - t0
        if not up.get("ok") or len(sup.replicas) != 2:
            raise AssertionError(f"{phase} scale_up: {up}")
        spawned = sup._by_idx(up["replica"])
        profs, threads = {}, []

        def on_token(n):
            if n == 2:
                threads.append(_profile_in_thread(
                    spawned.port, FA_PROFILE_MS, prof_dir, profs,
                    "spawned"))

        reply, streamed, _, _ = _routed(spawned.port, own,
                                        FA_PROFILE_NEW, on_token=on_token)
        for t in threads:
            t.join(timeout=600)
        check_tokens(f"{phase} the spawned replica's stream vs the "
                     f"in-process engine", [streamed, reply["generated"]],
                     [ref_own, ref_own])
        prof = profs.get("spawned") or {}
        if "trace_file" not in prof:
            raise AssertionError(f"{phase} profile: {prof}")
        counts, n = _kernel_event_counts(prof["trace_file"],
                                         FLEET_KERNELS["decode"])
        if not all(counts.values()):
            raise AssertionError(f"{phase}: the spawned replica's trace "
                                 f"lacks kernels {counts}")
        mem = prof["devices"][0]["memory_stats"] or {}
        out["spawned_replica"] = {
            "idx": spawned.idx, "kernel_events": n, "counts": counts,
            "allocated_bytes": mem.get("allocated_bytes.all.current"),
            "reserved_bytes": mem.get("reserved_bytes.all.current")}
        wave("after the scale-up")
        t0 = time.monotonic()
        down = asc.scale_down(reason="smoke", force=True)
        out["scale_down_s"] = time.monotonic() - t0
        if not down.get("ok") or len(sup.replicas) != 1 or not drains:
            raise AssertionError(f"{phase} scale_down: {down}")
        hand = drains[-1].get("handoff") or {}
        out["drain"] = {"victim": down["replica"],
                        "drained": drains[-1].get("drained"),
                        "handoff_pages": hand.get("imported_pages"),
                        "handoff_bytes": hand.get("bytes"),
                        "handoff_failures": len(hand.get("failures")
                                                or ())}
        wave("after the scale-down")
        # the chain only the victim held, served by the survivor
        reply, _, _, _ = _routed(router.port, own, FA_NEW, key="as-own")
        _fleet_tokens(torch, model, f"{phase} the victim's chain on the "
                      f"survivor", [reply.get("generated")],
                      [ref_own[:FA_NEW]], [own])
        out["drain"]["survivor_restored_pages"] = \
            (reply.get("stats") or {}).get("restored_pages")
        with open(journal) as f:
            lint = lint_fleet_journal(json.load(f), allow_open_tail=0)
        kinds = [a["action"] for a in asc.journal.tail(99)
                 if a.get("phase") == "begin"]
        leak = _rpc(sup.replicas[0].port, {"op": "leak_check"})
        out["journal"] = {"begins": kinds, "lint": lint,
                          "seq": asc.journal.seq}
        if kinds != ["spawn", "drain"] or lint or not leak.get("ok"):
            raise AssertionError(f"{phase}: journal {kinds} {lint}, "
                                 f"leak_check {leak}")
        out["actions_total"] = asc.status()["actions_total"]
    finally:
        if router is not None:
            router.stop()
        sup.stop()
    return out


def _chaos_summary(report):
    d = report.to_dict()
    keep = {k: v for k, v in d.items() if k != "details"}
    for det in d["details"]:
        if "i" in det:
            continue
        keep.setdefault("details", []).append(det)
    return keep


def phase_fleet_autoscale(torch, dev, model, card):
    """The autoscaler on the card at GPT-1.3B's full width (seed-0
    weights, fp32). (a) In this process: one replica (FLEET_SERVER_ARGS,
    a 512 MB host tier) under a ``Supervisor`` with an ``Autoscaler``
    behind a ``FailoverRouter``; 4 keyed prompts of 130-190 tokens, 16
    new tokens each, served one at a time; a forced ``scale_up``; the
    spawned replica streams 64 tokens of a fifth prompt under a profile
    window (the decode kernels in its trace); served again; a forced
    ``scale_down`` (drain with handoff: the fifth prompt's chain, then
    kill); served again, and the fifth prompt through the router on the
    survivor. Held: every reply equals the
    in-process engine's tokens, the journal's begins are spawn and drain
    and it lints clean (allow_open_tail=0), the survivor's leak_check.
    (b) ``run_autoscale_chaos``: the supervisor (a subprocess) SIGKILLed
    mid-spawn and mid-scale-down and restarted on its journal, 6 keyed
    requests of 2-3 pages. (c) ``run_roll_chaos``: the supervisor
    SIGKILLed mid-roll, a corrupt checkpoint, a replica SIGKILLed
    mid-roll (three 5.3 GB checkpoints under build/, deleted after).
    Held: each report ok, 2 recoveries in (b), no stranded process, no
    journal lint failure, no generation failure. Throughout, a thread
    reads which of the port's processes hold the card's device files
    (``/dev/nvidia*``, open in a process with a CUDA context): the
    replicas and this script do, no supervisor process (the chaos runs'
    subprocesses) may. ``nvidia-smi --query-compute-apps`` names every
    process pid 1 on this machine (the container's pid namespace), so
    its rows are printed but cannot name the processes."""
    import shutil
    from paddle_tpu_torch.tools import chaos_serving
    phase = "fleet_autoscale"
    out = {"phase": phase, "card": card, "model": FLEET_MODEL,
           "server_args": list(FLEET_SERVER_ARGS)}
    root = os.path.join(HERE, "build", "fleet-autoscale")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _free_engine_memory(torch)
    apps = _CardApps(torch)
    t_phase = time.monotonic()
    try:
        t0 = time.monotonic()
        out["live"] = fleet_autoscale_live(torch, model, root)
        out["live"]["wall_s"] = time.monotonic() - t0
        _free_engine_memory(torch)
        chaos_kw = dict(model=FLEET_MODEL, device=FA_DEVICE,
                        page_size=FA_CHAOS_PAGE,
                        max_seq_len=FA_CHAOS_MAX_SEQ, max_new_tokens=FA_NEW,
                        requests=FA_CHAOS_REQUESTS,
                        prompt_len_range=FA_CHAOS_LENGTHS)
        t0 = time.monotonic()
        rep = chaos_serving.run_autoscale_chaos(
            log_dir=os.path.join(root, "autoscale-chaos"), **chaos_kw)
        out["autoscale_chaos"] = dict(_chaos_summary(rep),
                                      phase_wall_s=time.monotonic() - t0)
        if not rep.ok or rep.recoveries != 2 or rep.stranded_processes \
                or rep.journal_lint_failures:
            FAILED_CHECKS.append(f"{phase} autoscale chaos: "
                                 f"{json.dumps(_chaos_summary(rep))[:4000]}")
        _free_engine_memory(torch)
        t0 = time.monotonic()
        rep = chaos_serving.run_roll_chaos(
            log_dir=os.path.join(root, "roll-chaos"), **chaos_kw)
        out["roll_chaos"] = dict(_chaos_summary(rep),
                                 phase_wall_s=time.monotonic() - t0)
        if not rep.ok or rep.generation_failures:
            FAILED_CHECKS.append(f"{phase} roll chaos: "
                                 f"{json.dumps(_chaos_summary(rep))[:4000]}")
        _free_engine_memory(torch)
    finally:
        out["card_apps"] = apps.stop()
        out["wall_s"] = time.monotonic() - t_phase
        shutil.rmtree(os.path.join(root, "roll-chaos"), ignore_errors=True)
    bad = _CardApps.failures(out["card_apps"])
    if bad is not None:
        FAILED_CHECKS.append(f"{phase}: a supervisor held the card, or "
                             f"no replica was seen holding it: {bad}")
    emit(dict(out, ok=True))


# -- phase 5k ----------------------------------------------------------------

GEN_B = 4                 # prompts a generate call
GEN_PROMPT = 1024         # their length: attention_fwd's streaming shape
GEN_NEW = 64              # new tokens of the one-launch and chunked modes
GEN_EAGER_NEW = 16        # the eager loop's: its cache grows by concat
GEN_PAGE = 64
GEN_SMALL = (512, 128)    # B=1 paged prefills: the single-block and
#                           folded attention_fwd shapes
GEN_TEMP = 0.8
GEN_TOP_K = 40
GEN_INT8_REL = 0.05       # converted logits against float, relative
#                           (tests/test_quant_sparsity_text.py:183)
GEN_LAYERS = 96           # 4 linears a block x 24, the tied head stays
GEN_ENGINE_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
GEN_ENGINE_NEW = 16
GEN_MODES = (
    ("static", dict(use_jit=True)),
    ("paged", dict(use_jit=True, kv_cache="paged", page_size=GEN_PAGE)),
    ("paged_int8", dict(use_jit=True, kv_cache="paged_int8",
                        page_size=GEN_PAGE)),
    ("chunked", dict(use_jit=True, compile_mode="chunked")),
    ("eager", {}),
)


def _gen_new(mode):
    return GEN_EAGER_NEW if mode == "eager" else GEN_NEW


def _generate(torch, model, ids, n, plain=False, **kw):
    """One ``generate`` call, synchronised: (tokens [B, S+n] on the host
    as lists, wall seconds)."""
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = model.generate(ids, max_new_tokens=n, **kw)
        torch.cuda.synchronize()
    return out.tolist(), time.monotonic() - t0


def gen_prefill_logits(torch, model, ids, kind, plain):
    """The last row's logits of a prefill of ``ids`` into a fresh cache
    of ``kind`` (the eager pair, a static buffer or paged pools), through
    the kernels or the plain versions: what each generate mode's first
    step computes."""
    from paddle_tpu_torch.models.gpt import (paged_cache_create,
                                             static_cache_create)
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    cfg = model.config
    b, s = ids.shape
    dev = model.device
    kw = {}
    if kind == "eager":
        caches = [None] * cfg.num_layers
    elif kind in ("static", "chunked"):
        caches = [static_cache_create(b, s, cfg.num_heads, cfg.head_dim,
                                      torch.float32, device=dev)
                  for _ in range(cfg.num_layers)]
    else:
        mp = -(-s // GEN_PAGE)
        caches = [paged_cache_create(b, b * mp, GEN_PAGE, cfg.num_heads,
                                     cfg.head_dim, torch.float32, mp,
                                     quantized=(kind == "paged_int8"),
                                     device=dev)
                  for _ in range(cfg.num_layers)]
        kw["prefill_lens"] = torch.full((b,), s, dtype=torch.int32,
                                        device=dev)
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx, torch.no_grad():
        logits, _ = model(ids, caches=caches, **kw)
    return logits[:, -1].clone()


def gen_launch_gate(mode, counts):
    """A generate run's launch counts (graph replays included): the
    paged modes launch the four serving kernels, the static one-launch
    mode the fused head and no paged decode; no training or ResNet
    kernel ran."""
    if mode in ("paged", "paged_int8"):
        serving_launch_gate(f"generate {mode}", counts)
    else:
        serving_launch_gate(f"generate {mode}", counts, need=())
    if mode == "static" and (counts["fused_argmax"] <= 0
                             or counts["paged_decode"] != 0):
        raise AssertionError(f"generate static: launches {counts}")


def _sampled_in_top_k(torch, model, out, s, k):
    """Whether each sampled token of ``out`` [B, S+N] lies in the top
    ``k`` of its step's logits, from one forward over the whole sequence
    (kernel path; a near-tie at the k-th value is allowed the model
    tolerance, since the forward and the decode step sum in other
    orders). Returns (all in, tokens checked)."""
    ids = torch.tensor(out, device=model.device)
    with torch.no_grad():
        logits = model(ids)[:, s - 1:-1]
    kth = torch.topk(logits, k, dim=-1).values[..., -1]
    picked = torch.gather(logits, -1, ids[:, s:, None])[..., 0]
    slack = MODEL_REL_TOL * logits.abs().amax(dim=-1)
    return bool((picked >= kth - slack).all()), int(picked.numel())


def _macro_graphs(eng):
    """The engine's captured iteration graphs (``inference/graphs.py``
    ``IterationGraphs``), None before its first macro launch."""
    return eng._macro["graphs"]


# the program cache's sweep: four signatures of each cache kind (batch
# and new tokens vary; the largest first), on the phase's prompts
GEN_SWEEP = ((GEN_B, 6), (GEN_B, 4), (GEN_B // 2, 6), (GEN_B // 2, 4))
# memory after a kind's sweep against after its first (largest)
# signature: one program's caches and graph, not four
GEN_SWEEP_SLACK = 1.05


def gen_cache_sweep(torch, model, ids):
    """Each cache kind's ``GEN_SWEEP`` in turn through the one-launch
    mode: after a kind's four signatures one program of that kind is
    live (one more a kind swept before), and the memory allocated beyond
    the kind's start is at most ``GEN_SWEEP_SLACK`` times that after its
    first signature. Returns per kind the live programs and the memory
    (GB) after the first call, after the sweep and at its peak."""
    model.clear_generate_cache()
    _free_engine_memory(torch)
    rec = {}
    for i, mode in enumerate(("static", "paged", "paged_int8")):
        kw = dict(GEN_MODES)[mode]
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        after = []
        for b, n in GEN_SWEEP:
            _generate(torch, model, ids[:b], n, temperature=0.0, **kw)
            torch.cuda.synchronize()
            after.append((torch.cuda.memory_allocated() - start) / 1e9)
        kinds = sorted(p.kv_cache for p in model._gen_programs.values())
        rec[mode] = {"live_programs": kinds,
                     "first_gb": after[0], "after_sweep_gb": after[-1],
                     "peak_gb": (torch.cuda.max_memory_allocated()
                                 - start) / 1e9}
        if kinds.count(mode) != 1 or len(kinds) != i + 1 or \
                not after[-1] <= GEN_SWEEP_SLACK * after[0]:
            raise AssertionError(f"generate program cache {mode}: "
                                 f"{rec[mode]}")
    model.clear_generate_cache()
    _free_engine_memory(torch)
    return rec


def phase_generate(torch, dev, model, card):
    """``GPTForCausalLM.generate`` at GPT-1.3B's full width (the engine
    phase's seed-0 model, fp32), ``GEN_B`` prompts of ``GEN_PROMPT``
    tokens:

    - each mode (one-launch static, paged and paged_int8 at page 64,
      chunked, each ``GEN_NEW`` tokens; the eager loop ``GEN_EAGER_NEW``)
      through the kernels and under ``plain_kernels()``: the prefill's
      last-row logits within ``MODEL_REL_TOL``, first tokens equal, token
      agreement; the kernel run's launches (graph replays included) gated
      by ``gen_launch_gate``; ms a decode step from a run of N tokens
      less a run of one, and each call's first (capture) and steady wall;
    - pins: chunked bitwise the static one-launch mode, the fused head
      bitwise the unfused head; static against paged agreement printed
      (the two attend through the plain math and ``paged_decode``);
    - B=1 paged runs at ``GEN_SMALL`` prompts (attention_fwd's other
      shapes), first token equal to the plain run's;
    - sampling (``GEN_TEMP``, top-k ``GEN_TOP_K``, the static one-launch
      mode): one seed twice gives one stream, another seed another,
      every token in its step's top k, ``top_k=1`` at temperature 1
      equals greedy;
    - weight-only int8: a ``multi_step=4`` engine serves 8 prompts
      (graphs captured), ``convert_to_weight_only_int8`` converts
      ``GEN_LAYERS`` layers, the static prefill's logits within
      ``GEN_INT8_REL`` of the float model's, chunked bitwise whole; the
      ``multi_step=4`` engine serves again on recaptured graphs (no
      ``decode_out_proj`` in them) with the tokens of a fresh per-token
      engine; an 8-slot engine through the kernels (``decode_out_proj``
      at 0, ``paged_decode`` and ``fused_argmax`` launched) with the
      first tokens of its plain run.

    The model is converted in place: no later phase uses it."""
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.quantization.quant import (
        convert_to_weight_only_int8)
    V = model.config.vocab_size
    _free_engine_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(15)
    ids = torch.randint(0, V, (GEN_B, GEN_PROMPT), generator=gen).to(dev)
    s = GEN_PROMPT
    out = {"phase": "generate", "card": card, "model": "gpt_1p3b",
           "batch": GEN_B,
           "prompt": GEN_PROMPT, "page_size": GEN_PAGE,
           "tol_rel": MODEL_REL_TOL}
    modes, toks = {}, {}
    for mode, kw in GEN_MODES:
        n = _gen_new(mode)
        rec = {"new_tokens": n}
        lk = gen_prefill_logits(torch, model, ids, mode, False)
        lp = gen_prefill_logits(torch, model, ids, mode, True)
        rec["prefill_logits_rel"] = rel_err(lk, lp)
        if mode == "static":
            float_logits = lk
        del lk, lp
        reset_launch_counts()
        kern, t_first = _generate(torch, model, ids, n, temperature=0.0,
                                  **kw)
        counts = launch_counts()
        gen_launch_gate(mode, counts)
        rec["launches"] = {k: v for k, v in counts.items() if v}
        again, t_steady = _generate(torch, model, ids, n, temperature=0.0,
                                    **kw)
        _, t_one = _generate(torch, model, ids, 1, temperature=0.0, **kw)
        _, t_one = _generate(torch, model, ids, 1, temperature=0.0, **kw)
        plain, t_plain = _generate(torch, model, ids, n, plain=True,
                                   temperature=0.0, **kw)
        new_k = [r[s:] for r in kern]
        new_p = [r[s:] for r in plain]
        _generation_ok(f"generate {mode}", new_k, n, V)
        rec.update(
            first_token_agreement=sum(a[0] == b[0] for a, b in
                                      zip(new_k, new_p)) / GEN_B,
            token_agreement=_agreement(new_k, new_p),
            repeat_bitwise=again == kern, first_call_s=t_first,
            steady_call_s=t_steady, prefill_only_call_s=t_one,
            plain_call_s=t_plain,
            ms_per_decode_step=(t_steady - t_one) * 1e3 / (n - 1),
            ms_per_token=(t_steady - t_one) * 1e3 / ((n - 1) * GEN_B))
        if not rec["prefill_logits_rel"] <= MODEL_REL_TOL:
            raise AssertionError(f"generate {mode}: prefill logits "
                                 f"{rec['prefill_logits_rel']:.3g}")
        if rec["first_token_agreement"] != 1.0 or not rec["repeat_bitwise"]:
            raise AssertionError(f"generate {mode}: {rec}")
        modes[mode], toks[mode] = rec, kern
        model.clear_generate_cache()
        _free_engine_memory(torch)
    out["modes"] = modes
    if toks["chunked"] != toks["static"]:
        raise AssertionError("generate: chunked is not bitwise the static "
                             "one-launch mode")
    # the unfused head: the static one-launch mode with head_params None
    # (another program: the signature holds whether the head is fused)
    model.head_params = lambda: None
    try:
        unfused, _ = _generate(torch, model, ids, GEN_NEW, temperature=0.0,
                               use_jit=True)
    finally:
        del model.head_params
    model.clear_generate_cache()
    if unfused != toks["static"]:
        raise AssertionError("generate: the unfused head's tokens differ")
    out["pins"] = {"chunked_bitwise_static": True,
                   "unfused_head_bitwise_fused": True,
                   "static_vs_paged_agreement": _agreement(
                       [r[s:] for r in toks["static"]],
                       [r[s:] for r in toks["paged"]]),
                   "paged_int8_vs_paged_agreement": _agreement(
                       [r[s:] for r in toks["paged_int8"]],
                       [r[s:] for r in toks["paged"]])}
    out["program_cache"] = gen_cache_sweep(torch, model, ids)
    small = {}
    for n_small in GEN_SMALL:
        one = ids[:1, :n_small]
        reset_launch_counts()
        k1, _ = _generate(torch, model, one, GEN_NEW, temperature=0.0,
                          **dict(GEN_MODES)["paged"])
        counts = serving_launch_gate(f"generate paged B=1 S={n_small}",
                                     launch_counts())
        p1, _ = _generate(torch, model, one, GEN_NEW, plain=True,
                          temperature=0.0, **dict(GEN_MODES)["paged"])
        if k1[0][n_small] != p1[0][n_small]:
            raise AssertionError(f"generate B=1 S={n_small}: first token")
        small[n_small] = {"attention_fwd": counts["attention_fwd"],
                          "token_agreement": _agreement(
                              [k1[0][n_small:]], [p1[0][n_small:]])}
    out["paged_b1"] = small
    model.clear_generate_cache()

    # sampling on the static one-launch mode (a graph with a registered
    # generator)
    def sampled(seed, temperature, top_k):
        g = torch.Generator(device=dev).manual_seed(seed)
        return _generate(torch, model, ids, GEN_NEW, use_jit=True,
                         temperature=temperature, top_k=top_k,
                         generator=g)[0]

    a, b = sampled(5, GEN_TEMP, GEN_TOP_K), sampled(5, GEN_TEMP, GEN_TOP_K)
    c = sampled(6, GEN_TEMP, GEN_TOP_K)
    in_top, checked = _sampled_in_top_k(torch, model, a, s, GEN_TOP_K)
    k1 = sampled(7, 1.0, 1)
    out["sampling"] = {"temperature": GEN_TEMP, "top_k": GEN_TOP_K,
                       "same_seed_equal": a == b, "other_seed_differs":
                       a != c, "in_top_k": in_top, "tokens_checked": checked,
                       "top_k_1_equals_greedy": k1 == toks["static"]}
    if not (a == b and a != c and in_top and k1 == toks["static"]):
        raise AssertionError(f"generate sampling: {out['sampling']}")
    model.clear_generate_cache()
    _free_engine_memory(torch)

    # weight-only int8: an engine whose graphs predate the conversion
    prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
               for n in GEN_ENGINE_LENGTHS]
    eng4 = create_decode_engine(model, device=dev, num_slots=8,
                                page_size=GEN_PAGE, num_pages=96,
                                multi_step=4)

    def serve(eng):
        rids = [eng.submit(p, max_new_tokens=GEN_ENGINE_NEW)
                for p in prompts]
        res = eng.run()
        eng.check_no_leak()
        return [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]

    serve(eng4)
    graphs_before = _macro_graphs(eng4)
    t0 = time.monotonic()
    n_conv = convert_to_weight_only_int8(model)
    torch.cuda.synchronize()
    conv_s = time.monotonic() - t0
    if n_conv != GEN_LAYERS:
        raise AssertionError(f"generate: {n_conv} layers converted, not "
                             f"{GEN_LAYERS}")
    _free_engine_memory(torch)
    int8_logits = gen_prefill_logits(torch, model, ids, "static", False)
    int8_rel = rel_err(int8_logits, float_logits)
    del int8_logits, float_logits
    whole, t_whole = _generate(torch, model, ids, GEN_NEW, temperature=0.0,
                               use_jit=True)
    _, t_whole = _generate(torch, model, ids, GEN_NEW, temperature=0.0,
                           use_jit=True)
    _, t_one = _generate(torch, model, ids, 1, temperature=0.0,
                         use_jit=True)
    chunked, _ = _generate(torch, model, ids, GEN_NEW, temperature=0.0,
                           use_jit=True, compile_mode="chunked")
    model.clear_generate_cache()
    _free_engine_memory(torch)
    if not int8_rel <= GEN_INT8_REL or chunked != whole:
        raise AssertionError(f"generate int8: logits rel {int8_rel:.3g}, "
                             f"chunked == whole {chunked == whole}")
    reset_launch_counts()
    got4 = serve(eng4)
    regraphed = _macro_graphs(eng4) is not graphs_before
    per_replay = _macro_graphs(eng4).kinds()["decode"]["launches"]
    eng4.close()
    _free_engine_memory(torch)
    eager1, _ = run_engine(torch, model, prompts, GEN_ENGINE_NEW, False)
    if not regraphed or "decode_out_proj" in per_replay or got4 != eager1:
        raise AssertionError(f"generate int8 multi_step=4: recaptured "
                             f"{regraphed}, per replay {per_replay}, "
                             f"tokens equal N=1 {got4 == eager1}")
    reset_launch_counts()
    kern8, info8 = run_engine(torch, model, prompts, GEN_ENGINE_NEW, False)
    counts = serving_launch_gate(
        "generate int8 engine", launch_counts(),
        need=("paged_decode", "fused_argmax", "attention_fwd"))
    plain8, _ = run_engine(torch, model, prompts, GEN_ENGINE_NEW, True)
    if counts["decode_out_proj"] != 0 or \
            [o[0] for o in kern8] != [o[0] for o in plain8]:
        raise AssertionError(f"generate int8 engine: {counts}")
    out["int8"] = {
        "layers_converted": n_conv, "convert_s": conv_s,
        "logits_rel_vs_float": int8_rel, "limit": GEN_INT8_REL,
        "chunked_bitwise_whole": True,
        "static_ms_per_decode_step": (t_whole - t_one) * 1e3 /
        (GEN_NEW - 1),
        "static_ms_per_token": (t_whole - t_one) * 1e3 /
        ((GEN_NEW - 1) * GEN_B),
        "multi_step4_recaptured": regraphed,
        "multi_step4_per_replay_launches": per_replay,
        "engine_launches": {k: v for k, v in counts.items() if v},
        "engine_token_agreement_vs_plain": _agreement(kern8, plain8),
        "engine_decode_step_ms_median": info8["decode_step_ms_median"]}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(dict(out, ok=True))


# -- phase 6 -----------------------------------------------------------------

def _train_model(torch, dev, **cfg_kw):
    """GPT-1.3B as ``bench.py`` trains it (fp32, dropout 0), seed-0
    weights; ``cfg_kw`` overrides fields (depth, remat, loss chunks)."""
    import dataclasses
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    cfg = dataclasses.replace(gpt_1p3b(dropout=0.0, attn_dropout=0.0),
                              **cfg_kw)
    return GPTForCausalLM(cfg, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(0))


def _loss_and_grads(torch, model, ids, plain: bool):
    """One forward+backward of the next-token loss through the kernels
    or (``plain``) their plain versions; returns (loss, {name: grad})."""
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    model.train()
    model.zero_grad(set_to_none=True)
    with plain_kernels(plain):
        loss = model(ids, labels=ids)
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _grad_rel(got, want):
    """Relative L2 error of every parameter's gradient."""
    return {n: float((got[n].float() - w.float()).norm()
                     / w.float().norm().clamp_min(1e-30))
            for n, w in want.items()}


def _check_train_parity(tag, loss_k, loss_p, errs):
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(errs, key=errs.get)
    if not loss_rel <= LOSS_REL_TOL:
        raise AssertionError(f"{tag}: loss {float(loss_k)} vs plain "
                             f"{float(loss_p)} ({loss_rel:.3g} relative)")
    if not errs[worst] <= GRAD_REL_TOL:
        raise AssertionError(f"{tag}: gradient of {worst} off by "
                             f"{errs[worst]:.3g} relative")
    return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel": loss_rel, "grad_rel_max": errs[worst],
            "grad_rel_max_param": worst}


def _snapshot(torch, step):
    """Copies of the parameters, the optimizer's state (updated in place
    by each step) and the step's generator."""
    opt = {k: v.clone() if torch.is_tensor(v) else v
           for k, v in step.optimizer.state_dict().items()}
    return ({n: p.detach().clone()
             for n, p in step.model.named_parameters()},
            opt, step.generator.get_state())


def _restore(torch, step, snap):
    params, opt_state, gen_state = snap
    with torch.no_grad():
        for n, p in step.model.named_parameters():
            p.copy_(params[n])
    step.optimizer.set_state_dict(opt_state)
    step.generator.set_state(gen_state)


def _step_vs_plain(torch, step, ids):
    """One ``TrainStep`` through the kernels, then the same step from
    the same state through the plain versions; returns the parity
    record and the kernel step's launch counts."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    snap = _snapshot(torch, step)
    reset_launch_counts()
    loss_k = step(ids)
    torch.cuda.synchronize()
    counts = launch_counts()
    grads_k = {n: p.grad.clone() for n, p in step.model.named_parameters()}
    _restore(torch, step, snap)
    with plain_kernels():
        loss_p = step(ids)
    errs = _grad_rel(grads_k, {n: p.grad for n, p in
                               step.model.named_parameters()})
    return _check_train_parity("train step", loss_k, loss_p, errs), counts


# kernel-name substrings -> the group a train step's device time is
# summed under (first match wins)
TRAIN_KERNEL_GROUPS = (
    ("attention kernels", ("attention_fwd", "attention_bwd", "dq_reduce")),
    ("adam_update", ("adam_update",)),
    ("GEMM", ("gemm", "cutlass", "xmma", "nvjet")),
    ("softmax / CE", ("softmax", "nll", "gather", "scatter")),
    ("layer norm", ("layer_norm",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


# kernel symbols whose launches ``profile_once`` counts by name
COUNTED_KERNELS = ("adam_update_kernel",)


def profile_once(torch, fn, groups=TRAIN_KERNEL_GROUPS, host_ops=True):
    """One call of ``fn`` under ``torch.profiler``: wall time, device
    kernel time by group (``groups``: name substrings, first match wins)
    and by kernel, launches, and the device's idle share. ``host_ops``
    False records the device alone: a loader's worker threads run
    thousands of host ops whose records took ~20 s to read back."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    by_name, by_group, counts = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        for key in COUNTED_KERNELS:
            if key in e.name:
                counts[key] = counts.get(key, 0) + 1
        low = e.name.lower()
        group = next((g for g, keys in groups
                      if any(k in low for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + us
    dev_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_kernel_ms": dev_ms,
            "kernels": len(kernels), "kernel_counts": counts,
            "kernel_names": sorted(by_name),
            "idle_share": 1.0 - dev_ms / wall_ms,
            "by_group_ms": {g: us / 1e3 for g, us in sorted(
                by_group.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:60], us / 1e3] for n, us in top]}


VARIANT_STEPS = 5  # kernel-path steps timed per 4-layer variant
# the kernels every full-depth train step launches (S=2048: the flash
# forward, the dQ and dK/dV passes, the optimizer update)
TRAIN_STEP_KERNELS = ("attention_fwd", "attention_bwd_dq",
                      "attention_bwd_dkv", "adam_update")


def _bit_sums(torch, state):
    """Each tensor of an optimizer ``state_dict`` summed as its integer
    bit patterns (int64): a fingerprint of the moments' bits that needs
    no second copy of them."""
    sums = []
    for _, t in sorted(state.items()):
        if torch.is_tensor(t):
            ity = torch.int32 if t.element_size() == 4 else torch.int16
            sums.append(t.view(ity).to(torch.int64).sum())
    return torch.stack(sums)


def _repeat_and_fused(torch, step, ids):
    """One step from one state three times: twice as it is, which must
    give the same bits, then under ``fuse_optimizer`` (each dtype group
    in one ``adam_update`` launch), which must give the same loss,
    parameters and moments (their bit sums, ``_bit_sums``) as the
    unfused step. Returns (True, the fused step's record); raises on a
    difference."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    model = step.model
    snap = _snapshot(torch, step)
    l1 = step(ids)
    p1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    s1 = _bit_sums(torch, step.optimizer.state_dict())
    _restore(torch, step, snap)
    l2 = step(ids)
    if not (torch.equal(l1, l2) and all(
            torch.equal(p1[n], p) for n, p in model.named_parameters())):
        raise AssertionError("one train step from one state gave two "
                             "results")
    _restore(torch, step, snap)
    del snap
    reset_launch_counts()
    set_flags({"fuse_optimizer": True})
    try:
        l3 = step(ids)
    finally:
        set_flags({"fuse_optimizer": False})
    torch.cuda.synchronize()
    groups = len({(p.dtype, step.optimizer.state_dict()[f"{n}.moment1"]
                   .dtype) for n, p in model.named_parameters()})
    fused = {"adam_update_launches": launch_counts()["adam_update"],
             "dtype_groups": groups}
    same = torch.equal(l1, l3) and all(
        torch.equal(p1[n], p) for n, p in model.named_parameters()) and \
        torch.equal(s1, _bit_sums(torch, step.optimizer.state_dict()))
    if not same:
        raise AssertionError("the fuse_optimizer step differs from the "
                             "unfused step")
    if fused["adam_update_launches"] != groups:
        raise AssertionError(f"fuse_optimizer: {fused} (one launch a "
                             f"group)")
    fused["bitwise_equal_unfused"] = True
    return True, fused


def phase_train(torch, dev, launches):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import AdamW
    B, S = 2, 2048
    # (a) full depth, one forward+backward: kernels against plain
    model = _train_model(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, model.config.vocab_size, (B, S), generator=gen,
                        device=dev)
    loss_k, grads_k = _loss_and_grads(torch, model, ids, plain=False)
    loss_p, grads_p = _loss_and_grads(torch, model, ids, plain=True)
    errs = _grad_rel(grads_k, grads_p)
    rec = _check_train_parity("train parity", loss_k, loss_p, errs)
    del grads_k, grads_p
    emit({"phase": "train_parity", "ok": True, "model": "gpt_1p3b",
          "layers": model.config.num_layers, "B": B, "S": S,
          "tol": {"loss_rel": LOSS_REL_TOL, "grad_rel": GRAD_REL_TOL},
          **rec, "grad_rel": {n: float(f"{e:.3g}")
                              for n, e in errs.items()}})

    # (b) the main path: TrainStep.multi_step on a repeated batch
    step = TrainStep(model, AdamW(learning_rate=TRAIN_LR), lambda m, x:
                     m(x, labels=x), seed=0, device=dev)
    first = float(step(ids))  # warm-up step: Adam slots allocated here
    n_steps = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.monotonic()
    losses = step.multi_step(ids[None].expand(n_steps, B, S))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses do not fall: {first} "
                             f"{losses}")
    for name in TRAIN_STEP_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    qkv_grads = [float(blk.attn.qkv_proj.weight.grad.norm())
                 for blk in model.gpt.h]
    if not all(math.isfinite(g) and g > 0.0 for g in qkv_grads):
        raise AssertionError(f"qkv_proj gradients: {qkv_grads}")
    same, fused = _repeat_and_fused(torch, step, ids)
    prof = profile_once(torch, lambda: step(ids))
    emit({"phase": "train", "ok": True, "model": "gpt_1p3b",
          "layers": model.config.num_layers, "B": B, "S": S,
          "optimizer": f"AdamW({TRAIN_LR})", "warmup_loss": first,
          "losses": losses, "ms_per_step": wall * 1e3 / n_steps,
          "tokens_per_s": B * S * n_steps / wall,
          "peak_mem_gb": peak / 1e9, "mem_before_gb": mem_before / 1e9,
          "launches": counts,
          "qkv_proj_grad_norm_min": min(qkv_grads),
          "repeat_step_bitwise_equal": same, "fuse_optimizer": fused,
          "step_profile": prof})
    for name in ("attention_bwd_dq", "attention_bwd_dkv", "adam_update"):
        launches[name] = counts[name]
    del step, model
    torch.cuda.empty_cache()

    # (c) the other backward kernels, (d) remat + chunked loss: one
    # step each through the kernels against the plain step, 4 layers
    variants = (("S=512", {}, 512, "attention_bwd_fused"),
                ("S=256", {}, 256, "folded_attention_bwd"),
                ("remat+loss_chunk_size=512 S=2048",
                 dict(remat=True, loss_chunk_size=512), 2048,
                 "attention_bwd_dq"),
                ("remat_save_attention+loss_chunk_size=512 S=2048",
                 dict(remat=True, remat_save_attention=True,
                      loss_chunk_size=512), 2048, "attention_bwd_dq"))
    for tag, kw, s, kernel in variants:
        model = _train_model(torch, dev, num_layers=4, **kw)
        step = TrainStep(model, AdamW(learning_rate=TRAIN_LR), lambda m, x:
                         m(x, labels=x), seed=0, device=dev)
        step(ids[:, :s])  # a first step, so Adam's moments are live
        rec, counts = _step_vs_plain(torch, step, ids[:, :s])
        if counts[kernel] <= 0:
            raise AssertionError(f"{tag}: kernel {kernel} not launched")
        if kernel in ("attention_bwd_fused", "folded_attention_bwd"):
            launches[kernel] = counts[kernel]
        if kw:  # the chunked loss against the full-logits loss
            with torch.no_grad():
                chunked = float(model(ids[:, :s], labels=ids[:, :s]))
                model.config.loss_chunk_size = 0
                full = float(model(ids[:, :s], labels=ids[:, :s]))
            rec["loss_rel_chunked_vs_full"] = abs(chunked - full) / full
            if not rec["loss_rel_chunked_vs_full"] <= LOSS_REL_TOL:
                raise AssertionError(f"{tag}: chunked loss {chunked} vs "
                                     f"full {full}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(VARIANT_STEPS):
            step(ids[:, :s])
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / VARIANT_STEPS
        emit({"phase": "train_variant", "ok": True, "variant": tag,
              "layers": 4, "B": B, "S": s, **rec, "launches": counts,
              "ms_per_step": ms, "tokens_per_s": B * s / ms * 1e3})
        del step, model
        torch.cuda.empty_cache()
    remat_memory(torch, dev, ids)


REMAT_LAYERS = 4


def remat_memory(torch, dev, ids):
    """One forward+backward at 4 layers, B=2, S=2048, chunked loss, with
    no remat, remat and remat with saved attention, from the same seed-0
    weights: the saved-attention gradients bitwise equal to remat's,
    ``attention_fwd`` launched once a layer (remat: twice), and the peak
    memory above the step's start, and the memory the forward keeps for
    the backward, in between remat's and no remat's."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    runs = {}
    for tag, kw in (("no remat", {}), ("remat", dict(remat=True)),
                    ("remat_save_attention",
                     dict(remat=True, remat_save_attention=True))):
        model = _train_model(torch, dev, num_layers=REMAT_LAYERS,
                             loss_chunk_size=512, **kw)
        model.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_launch_counts()
        loss = model(ids, labels=ids)
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - start
        loss.backward()
        torch.cuda.synchronize()
        runs[tag] = dict(loss=loss.detach(),
                         grads={n: p.grad for n, p in
                                model.named_parameters()},
                         peak_gb=(torch.cuda.max_memory_allocated() - start)
                         / 1e9, after_forward_gb=kept / 1e9,
                         attention_fwd=launch_counts()["attention_fwd"])
        del model, loss
    want, got = runs["remat"], runs["remat_save_attention"]
    same = torch.equal(want["loss"], got["loss"]) and all(
        torch.equal(g, got["grads"][n]) for n, g in want["grads"].items())
    if not same:
        raise AssertionError("remat_save_attention: gradients differ from "
                             "remat's")
    fwd = {tag: r["attention_fwd"] for tag, r in runs.items()}
    if fwd != {"no remat": REMAT_LAYERS, "remat": 2 * REMAT_LAYERS,
               "remat_save_attention": REMAT_LAYERS}:
        raise AssertionError(f"attention_fwd launches {fwd}")
    peak = {tag: r["peak_gb"] for tag, r in runs.items()}
    kept = {tag: r["after_forward_gb"] for tag, r in runs.items()}
    for what in (peak, kept):
        if not what["remat"] <= what["remat_save_attention"] \
                <= what["no remat"]:
            raise AssertionError(f"remat_save_attention memory {what}")
    emit({"phase": "train_remat_memory", "ok": True,
          "layers": REMAT_LAYERS, "B": ids.shape[0], "S": ids.shape[1],
          "loss_chunk_size": 512, "peak_gb_above_start": peak,
          "kept_after_forward_gb": kept,
          "attention_fwd_launches": fwd,
          "grads_bitwise_equal_remat": same})
    del runs, want, got
    torch.cuda.empty_cache()


# -- phase 6b ----------------------------------------------------------------

# the bf16 recipe of the JAX headline step (bench_all.py
# _to_bf16_except_norms): bf16 weights and buffers, fp32 for every
# parameter whose name holds one of these
BF16_KEEP_TOKENS = ("bn", "norm", "ln_")
# kernel path against plain path in bf16. u = 2^-8 is bf16's unit
# roundoff (8 significant bits). The two paths round at other places:
# the kernels carry P in two bf16 terms and sum in their own order, the
# plain path rounds P to one bf16 term, so an attention output differs
# by up to an ulp (2u relative), and every later bf16 rounding can turn
# a difference below an ulp into a whole one.
# - loss: a bf16 value in both paths (log-softmax and mean in bf16, as
#   the JAX model computes it); their unrounded values lie far closer
#   than an ulp, so the roundings are at most one ulp apart: 2u relative.
# - gradients: the differences of 24 layers add as independent
#   roundings, sqrt(24) ~ 5 of them, each up to u: the L2 error over all
#   gradients within 8u; a parameter whose gradient sums terms of both
#   signs over the B*S positions (the layer norms' scales and biases)
#   loses up to a factor 2 more to cancellation: 16u each.
BF16_U = 2.0 ** -8
BF16_LOSS_REL_TOL = 2 * BF16_U
BF16_GRAD_REL_TOL = 8 * BF16_U
BF16_PARAM_GRAD_REL_TOL = 16 * BF16_U
BF16_VOCAB = 32768  # bench.py:129


def to_bf16_except_norms(torch, model):
    """The bf16 recipe (``bench_all._to_bf16_except_norms``) in place, as
    it acts: every floating parameter and buffer in bf16, then fp32 for
    each parameter whose name holds a keep-token. The JAX recipe's loop
    over the buffers would widen them again, but it asks
    ``np.issubdtype(dtype, np.floating)``, which is false for ml_dtypes'
    bfloat16; so the BN running statistics stay bf16 there, and here
    (GPT and BERT hold no buffers)."""
    model.to(torch.bfloat16)
    for name, p in model.named_parameters():
        if any(t in name for t in BF16_KEEP_TOKENS):
            p.data = p.data.float()
    return model


def train_flops(B, S, layers, E, V):
    """Model FLOPs of one train step, forward and backward (3x the
    forward), at 2 flops a multiply-add: per token 24 E^2 a layer (the
    qkv, out, fc_in and fc_out products) and 2 E V for the tied head;
    per sequence and layer 4 E per visible (query, key) pair for QK^T
    and PV, S (S + 1) / 2 pairs causal. Lookups, norms, elementwise work
    and remat's recompute are not counted."""
    fwd = (B * S * (layers * 24 * E * E + 2 * E * V)
           + B * layers * 4 * E * (S * (S + 1) // 2))
    return 3 * fwd


def _check_bf16_parity(loss_k, loss_p, grads_k, grads_p):
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = _grad_rel(grads_k, grads_p)
    num = sum(float((grads_k[n].float() - w.float()).norm()) ** 2
              for n, w in grads_p.items())
    den = sum(float(w.float().norm()) ** 2 for w in grads_p.values())
    global_rel = math.sqrt(num / den)
    worst = max(errs, key=errs.get)
    if not loss_rel <= BF16_LOSS_REL_TOL:
        raise AssertionError(f"train bf16: loss {float(loss_k)} vs plain "
                             f"{float(loss_p)} ({loss_rel:.3g} relative)")
    if not global_rel <= BF16_GRAD_REL_TOL:
        raise AssertionError(f"train bf16: gradients off by {global_rel:.3g}"
                             f" relative (all parameters)")
    if not errs[worst] <= BF16_PARAM_GRAD_REL_TOL:
        raise AssertionError(f"train bf16: gradient of {worst} off by "
                             f"{errs[worst]:.3g} relative")
    return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel": loss_rel, "grad_rel_all": global_rel,
            "grad_rel_max": errs[worst], "grad_rel_max_param": worst,
            "grad_rel": {n: float(f"{e:.3g}") for n, e in errs.items()}}


def phase_train_bf16(torch, dev, launches):
    """The JAX headline step (``bench.py:119-138``) at full depth:
    GPT-1.3B, V=32768, 24 layers, the bf16 recipe, bf16 Adam slots,
    ``AdamW(1e-4)``, B=2, S=2048, flash on, ``loss_chunk_size=0``. One
    forward+backward through the kernels against the plain path (the
    ``BF16_*_TOL`` limits), then ``multi_step`` over 6 steps (losses
    fall; the attention kernels and ``adam_update`` launched), ms a step,
    tokens/s, peak memory and MFU against 989 TFLOP/s bf16, one step
    repeated bitwise and under ``fuse_optimizer``, one profiled step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import AdamW
    B, S = 2, 2048
    model = to_bf16_except_norms(torch, _train_model(
        torch, dev, vocab_size=BF16_VOCAB, dtype="bfloat16"))
    cfg = model.config
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, BF16_VOCAB, (B, S), generator=gen, device=dev)
    loss_k, grads_k = _loss_and_grads(torch, model, ids, plain=False)
    loss_p, grads_p = _loss_and_grads(torch, model, ids, plain=True)
    rec = _check_bf16_parity(loss_k, loss_p, grads_k, grads_p)
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    del grads_k, grads_p
    emit({"phase": "train_bf16_parity", "ok": True, "model": "gpt_1p3b",
          "layers": cfg.num_layers, "vocab": BF16_VOCAB, "B": B, "S": S,
          "param_dtypes": dtypes, "loss_dtype": str(loss_k.dtype),
          "tol": {"loss_rel": BF16_LOSS_REL_TOL,
                  "grad_rel_all": BF16_GRAD_REL_TOL,
                  "grad_rel_param": BF16_PARAM_GRAD_REL_TOL}, **rec})

    step = TrainStep(model, AdamW(learning_rate=TRAIN_LR), lambda m, x:
                     m(x, labels=x), seed=0, device=dev)
    first = float(step(ids))  # warm-up step: Adam slots allocated here
    slot_dtypes = sorted({str(v.dtype) for v in
                          step.optimizer.state_dict().values()
                          if torch.is_tensor(v)})
    n_steps = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.monotonic()
    losses = step.multi_step(ids[None].expand(n_steps, B, S))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses.float().tolist()]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 train losses do not fall: {first} "
                             f"{losses}")
    for name in TRAIN_STEP_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"bf16 training path")
    same, fused = _repeat_and_fused(torch, step, ids)
    prof = profile_once(torch, lambda: step(ids))
    ms = wall * 1e3 / n_steps
    flops = train_flops(B, S, cfg.num_layers, cfg.hidden_size, BF16_VOCAB)
    emit({"phase": "train_bf16", "ok": True, "model": "gpt_1p3b",
          "layers": cfg.num_layers, "vocab": BF16_VOCAB, "B": B, "S": S,
          "optimizer": f"AdamW({TRAIN_LR})", "slot_dtypes": slot_dtypes,
          "warmup_loss": first, "losses": losses, "ms_per_step": ms,
          "tokens_per_s": B * S * n_steps / wall,
          "peak_mem_gb": peak / 1e9, "mem_before_gb": mem_before / 1e9,
          "flops_per_step": flops,
          "mfu": flops / (ms * 1e-3) / BF16_FLOPS,
          "launches": counts, "repeat_step_bitwise_equal": same,
          "fuse_optimizer": fused, "step_profile": prof})
    del step, model
    torch.cuda.empty_cache()


# -- phase 6c ----------------------------------------------------------------

# train_amp: GPT-1.3B at published widths (V=32768 as in train_bf16),
# fp32 master weights, B=2, S=2048, AdamW(1e-4)
AMP_STEPS = 6            # (a): multi_step under auto_cast bf16
AMP_SCALER_STEPS = 8     # (b): the fp16 + GradScaler eager loop
AMP_INF_STEP = 3         # (b): the step whose gradient gets an inf
AMP_O2_STEPS = 2         # (c): decorate(level="O2", dtype="float16")
# (c): an eps fp16 holds. 1e-8 rounds to 0 in an fp16 slot, and where v
# underflows the step is lr * m / eps: at 1e-8 a weight of size 0.02
# moves by ~1 (the kernel, the plain version and the JAX rule alike)
AMP_O2_EPS = 1e-4
AMP_LOOK_STEPS = 3       # (d): Lookahead(k=2) and EMA over (a)'s step
AMP_LOOK_K = 2
AMP_DGC_LAYERS = 4       # (e): DGCMomentum at 4 layers
AMP_DGC_STEPS = 6
AMP_DGC_TIMED = 3        # (e): more steps, timed without the watch
AMP_DGC_BEGIN = 2
AMP_DGC_RAMP = 4
# the DGC paper's warm-up sparsities (Lin et al., 2018: 75%, 93.75%,
# 98.4375%, 99.6%, 99.9%)
AMP_DGC_SPARSITY = (0.75, 0.9375, 0.984375, 0.996, 0.999)
AMP_DGC_LR = 1e-3
# the share of a tensor's sample at or above its threshold is 1 -
# sparsity up to the quantile's resolution (the interpolation and ties
# at it): held within 2 sample elements. The share of the whole tensor
# is reported against what a random sample of that size would give
# (4 sigmas of sqrt(p (1 - p) / n_s), plus one element): the
# reference's sample is strided, not random
AMP_DGC_SAMPLE_SLACK = 2.0
AMP_DGC_SIGMAS = 4.0
# fp16 single pass and folded backward: one 4-layer step each at the
# shapes their gates admit
AMP_FP16_VARIANTS = (("S=512", 512, "attention_bwd_fused"),
                     ("S=256", 256, "folded_attention_bwd"))


def _amp_fn(dtype, level="O1"):
    """A ``train_fn`` whose forward runs under ``auto_cast``."""
    from paddle_tpu_torch.amp import auto_cast

    def fn(m, x):
        with auto_cast(dtype=dtype, level=level):
            return m(x, labels=x)
    return fn


def _amp_loss_and_grads(torch, model, ids, dtype, plain: bool):
    """``_loss_and_grads`` with the forward under ``auto_cast``."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    model.train()
    model.zero_grad(set_to_none=True)
    with plain_kernels(plain):
        with auto_cast(dtype=dtype):
            loss = model(ids, labels=ids)
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _cast_counts(torch, model, ids, dtype, level="O1"):
    """(op, target dtype) -> count of one forward's ``amp_cast`` calls."""
    from paddle_tpu_torch.amp import auto_cast, record_casts
    with torch.no_grad(), record_casts() as seen, \
            auto_cast(dtype=dtype, level=level):
        model(ids[:, :256], labels=ids[:, :256])
    counts = {}
    for name, target in seen:
        key = f"{name}->{str(target).replace('torch.', '')}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def _params_equal(torch, model, snap) -> bool:
    return all(torch.equal(p.detach(), snap[n])
               for n, p in model.named_parameters())


def _eval_loss(torch, model, ids, dtype):
    from paddle_tpu_torch.amp import auto_cast
    model.eval()
    with torch.no_grad(), auto_cast(dtype=dtype):
        return float(model(ids, labels=ids))


def amp_bf16_and_wrappers(torch, dev, ids):
    """(a) and (d): the bf16 O1 step (kernels against plain, then
    ``multi_step``), then Lookahead and EMA over more of its steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import (AdamW, ExponentialMovingAverage,
                                            Lookahead)
    B, S = ids.shape
    model = _train_model(torch, dev, vocab_size=BF16_VOCAB)
    cfg = model.config
    casts = _cast_counts(torch, model, ids, "bfloat16")
    loss_k, grads_k = _amp_loss_and_grads(torch, model, ids, "bfloat16",
                                          False)
    loss_p, grads_p = _amp_loss_and_grads(torch, model, ids, "bfloat16",
                                          True)
    grad_dtypes = sorted({str(g.dtype) for g in grads_k.values()})
    rec = _check_bf16_parity(loss_k, loss_p, grads_k, grads_p)
    del grads_k, grads_p
    if grad_dtypes != ["torch.float32"] or loss_k.dtype != torch.float32:
        raise AssertionError(f"train_amp bf16: gradients {grad_dtypes}, "
                             f"loss {loss_k.dtype}")
    step = TrainStep(model, AdamW(learning_rate=TRAIN_LR),
                     _amp_fn("bfloat16"), seed=0, device=dev)
    first = float(step(ids))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    losses = step.multi_step(ids[None].expand(AMP_STEPS, B, S))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_amp bf16 losses do not fall: {first} "
                             f"{losses}")
    for name in TRAIN_STEP_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"train_amp bf16: {name} not launched")
    ms = wall * 1e3 / AMP_STEPS
    flops = train_flops(B, S, cfg.num_layers, cfg.hidden_size, BF16_VOCAB)
    out_a = {"phase": "train_amp_bf16", "ok": True, "model": "gpt_1p3b",
             "layers": cfg.num_layers, "vocab": BF16_VOCAB, "B": B, "S": S,
             "recipe": "auto_cast(dtype='bfloat16') O1, fp32 master "
                       "weights", "optimizer": f"AdamW({TRAIN_LR})",
             "casts_per_forward": casts, "tol": {
                 "loss_rel": BF16_LOSS_REL_TOL,
                 "grad_rel_all": BF16_GRAD_REL_TOL,
                 "grad_rel_param": BF16_PARAM_GRAD_REL_TOL},
             "parity": rec, "grad_dtypes": grad_dtypes,
             "warmup_loss": first, "losses": losses, "ms_per_step": ms,
             "tokens_per_s": B * S * AMP_STEPS / wall,
             "peak_mem_gb": peak / 1e9, "flops_per_step": flops,
             "mfu": flops / (ms * 1e-3) / BF16_FLOPS,
             "launches": {k: v for k, v in counts.items() if v}}
    emit(out_a)

    # (d) Lookahead around the step's AdamW and an EMA of the weights
    look = Lookahead(step.optimizer, alpha=0.5, k=AMP_LOOK_K)
    step.optimizer = look
    ema = ExponentialMovingAverage(model, decay=0.999)
    synced = []
    for i in range(AMP_LOOK_STEPS):
        step(ids)
        ema.update()
        if (i + 1) % AMP_LOOK_K == 0:
            synced.append(all(torch.equal(p.detach(), look._slow[id(p)])
                              for p in model.parameters()))
    torch.cuda.synchronize()
    if not synced or not all(synced):
        raise AssertionError(f"Lookahead: fast weights not the slow ones "
                             f"after a sync step: {synced}")
    snap = {n: p.detach().clone() for n, p in model.named_parameters()}
    outside = _eval_loss(torch, model, ids, "bfloat16")
    ema.apply()
    on_shadow = all(torch.equal(p.detach(), ema._shadow[id(p)])
                    for p in model.parameters())
    ema.restore()
    identity = _params_equal(torch, model, snap)
    with ema.apply_guard():
        guarded = all(torch.equal(p.detach(), ema._shadow[id(p)])
                      for p in model.parameters())
        inside = _eval_loss(torch, model, ids, "bfloat16")
    identity = identity and _params_equal(torch, model, snap)
    del snap
    if not (on_shadow and guarded and identity and inside != outside):
        raise AssertionError(f"EMA: apply on the shadow {on_shadow}, "
                             f"guard {guarded}, apply+restore identity "
                             f"{identity}, eval {inside} vs {outside}")
    emit({"phase": "train_amp_wrappers", "ok": True,
          "lookahead": {"alpha": 0.5, "k": AMP_LOOK_K,
                        "steps": AMP_LOOK_STEPS,
                        "fast_equals_slow_after_sync": synced},
          "ema": {"decay": 0.999, "updates": ema._step,
                  "apply_restore_bitwise_identity": identity,
                  "params_equal_shadow_in_guard": guarded,
                  "eval_loss_on_shadow": inside,
                  "eval_loss_on_weights": outside}})
    del step, look, ema, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def amp_fp16_scaler(torch, dev, ids, launches):
    """(b) the fp16 O1 recipe with ``GradScaler()`` as an eager loop
    (``tests/test_end_to_end.py:174-187``), an inf planted at
    ``AMP_INF_STEP``; then one 4-layer step at each of
    ``AMP_FP16_VARIANTS``; (c) the (b) model under ``decorate(level="O2",
    dtype="float16")`` with a fresh ``GradScaler``. Returns the (b)
    launch counts."""
    from paddle_tpu_torch.amp import GradScaler, auto_cast, decorate
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import AdamW
    B, S = ids.shape
    model = _train_model(torch, dev, vocab_size=BF16_VOCAB)
    casts = _cast_counts(torch, model, ids, "float16")
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.named_parameters())
    scaler = GradScaler()
    path, skipped, losses, step_ms = [], [], [], []
    planted = {}
    reset_launch_counts()
    for i in range(AMP_SCALER_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model.train()
        opt.clear_grad()
        with auto_cast(dtype="float16"):
            loss = model(ids, labels=ids)
        scaler.scale(loss).backward()
        if i == AMP_INF_STEP:
            w = model.gpt.h[0].mlp.fc_in.weight
            w.grad.view(-1)[0] = float("inf")
            snap = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
            planted["step_count_before"] = opt._global_step
        before = opt._global_step
        scaler.step(opt)
        scaler.update()
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        if opt._global_step == before:
            skipped.append(i)
        if i == AMP_INF_STEP:
            planted.update(step_count_after=opt._global_step,
                           params_bitwise_unchanged=_params_equal(
                               torch, model, snap))
            del snap
        path.append(scaler.get_loss_scaling())
        losses.append(float(loss.detach()))
    counts = launch_counts()
    if not (planted["params_bitwise_unchanged"] and
            planted["step_count_after"] == planted["step_count_before"]
            and AMP_INF_STEP in skipped):
        raise AssertionError(f"GradScaler: the planted inf step {planted}, "
                             f"skipped {skipped}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_amp fp16 losses: {losses}")
    for name in TRAIN_STEP_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"train_amp fp16: {name} not launched")
    for name in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv"):
        launches[f"{name}_fp16"] = counts[name]
    steady = sorted(step_ms[1:])
    emit({"phase": "train_amp_fp16", "ok": True, "model": "gpt_1p3b",
          "layers": model.config.num_layers, "vocab": BF16_VOCAB, "B": B,
          "S": S, "recipe": "auto_cast(dtype='float16') O1, fp32 master "
                            "weights, GradScaler() at its defaults",
          "casts_per_forward": casts, "losses": losses,
          "scale_path": path, "skipped_steps": skipped,
          "planted_inf_step": AMP_INF_STEP, "planted": planted,
          "ms_per_step_median": steady[len(steady) // 2],
          "tokens_per_s": B * S / steady[len(steady) // 2] * 1e3,
          "launches": {k: v for k, v in counts.items() if v},
          "state_dict": scaler.state_dict()})

    # (c) O2: the model in fp16, fp16 Adam slots, a fresh GradScaler
    decorate(model, level="O2", dtype="float16")
    opt = AdamW(learning_rate=TRAIN_LR, epsilon=AMP_O2_EPS,
                parameters=model.named_parameters())
    scaler = GradScaler()
    reset_launch_counts()
    o2_losses = []
    for _ in range(AMP_O2_STEPS):
        model.train()
        opt.clear_grad()
        with auto_cast(dtype="float16", level="O2"):
            loss = model(ids, labels=ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        o2_losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    o2 = launch_counts()
    dtypes = sorted({str(p.dtype) for p in model.parameters()} |
                    {str(t.dtype) for t in opt.state_dict().values()
                     if torch.is_tensor(t)})
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if o2["adam_update"] <= 0 or dtypes != ["torch.float16"] or \
            not finite or not all(map(math.isfinite, o2_losses)):
        raise AssertionError(f"train_amp O2: adam launches "
                             f"{o2['adam_update']}, dtypes {dtypes}, "
                             f"finite {finite}, losses {o2_losses}")
    launches["adam_update_fp16"] = o2["adam_update"]
    emit({"phase": "train_amp_o2", "ok": True,
          "recipe": "decorate(level='O2', dtype='float16'), "
                    "auto_cast(level='O2'), GradScaler()",
          "steps_applied": opt._global_step,
          "optimizer": f"AdamW({TRAIN_LR}, epsilon={AMP_O2_EPS})",
          "losses": o2_losses, "param_and_slot_dtypes": dtypes,
          "launches": {k: v for k, v in o2.items() if v}})
    del model, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()

    for tag, s, kernel in AMP_FP16_VARIANTS:
        model = _train_model(torch, dev, num_layers=4, vocab_size=BF16_VOCAB)
        opt = AdamW(learning_rate=TRAIN_LR,
                    parameters=model.named_parameters())
        scaler = GradScaler()
        reset_launch_counts()
        with auto_cast(dtype="float16"):
            loss = model(ids[:, :s], labels=ids[:, :s])
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        torch.cuda.synchronize()
        n = launch_counts()[kernel]
        if n <= 0 or not math.isfinite(float(loss)):
            raise AssertionError(f"train_amp fp16 {tag}: {kernel} "
                                 f"launched {n}, loss {float(loss)}")
        launches[f"{kernel}_fp16"] = n
        emit({"phase": "train_amp_fp16_variant", "ok": True, "variant": tag,
              "layers": 4, "B": B, "S": s, "loss": float(loss),
              "kernel": kernel, "launches": n})
        del model, opt, scaler
        torch.cuda.empty_cache()
    return counts


def amp_dgc(torch, dev, ids):
    """(e) ``DGCMomentum`` at 4 layers: ``AMP_DGC_STEPS`` train steps,
    plain momentum through ``AMP_DGC_BEGIN``, then the sparsity ramp.
    Each compressed tensor's threshold is read where the optimizer takes
    it (``dgc._threshold``, wrapped): the share of its strided sample at
    or above it must be 1 - sparsity within ``AMP_DGC_SAMPLE_SLACK``
    sample elements (the quantile's own resolution), and the share of
    the whole tensor, the entries the step applies, is reported beside
    1 - sparsity and the error a random sample of that size would have
    (``AMP_DGC_SIGMAS`` sigmas). Then ``AMP_DGC_TIMED`` steps without the
    watch: ms a step beside ``Momentum``'s on the same model."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import DGCMomentum, Momentum
    from paddle_tpu_torch.optimizer import dgc as dgc_mod
    B, S = ids.shape
    rec = {}
    seen = []
    real = dgc_mod._threshold

    def watched(v_abs, sparsity):
        thr = real(v_abs, sparsity)
        flat = v_abs.reshape(-1).to(torch.float32)
        sample = flat[::max(1, flat.numel() // dgc_mod._SAMPLE_CAP)]
        seen.append((sparsity, sample.numel(),
                     float((sample >= thr).float().mean()),
                     float((flat >= thr).float().mean())))
        return thr

    worst_sample, over_random = [], []
    for label in ("Momentum", "DGCMomentum"):
        model = _train_model(torch, dev, num_layers=AMP_DGC_LAYERS,
                             vocab_size=BF16_VOCAB)
        if label == "Momentum":
            opt = Momentum(learning_rate=AMP_DGC_LR, momentum=0.9)
        else:
            opt = DGCMomentum(learning_rate=AMP_DGC_LR, momentum=0.9,
                              rampup_begin_step=AMP_DGC_BEGIN,
                              rampup_step=AMP_DGC_RAMP,
                              sparsity=AMP_DGC_SPARSITY)
        step = TrainStep(model, opt, lambda m, x: m(x, labels=x), seed=0,
                         device=dev)
        names = [n for n, p in model.named_parameters() if p.numel() > 1]
        losses, shares = [], []
        dgc_mod._threshold = watched
        try:
            for i in range(1, AMP_DGC_STEPS + 1):
                seen.clear()
                losses.append(float(step(ids)))
                if label == "Momentum" or i <= AMP_DGC_BEGIN:
                    if seen:
                        raise AssertionError(f"DGC step {i}: compressed "
                                             f"before its warm-up ended")
                    continue
                if len(seen) != len(names):
                    raise AssertionError(f"DGC step {i}: {len(seen)} "
                                         f"thresholds for {len(names)} "
                                         f"tensors")
                want = 1.0 - float(opt.sparsity_at(i))
                per = {}
                for n, (sp, n_s, s_share, applied) in zip(names, seen):
                    random_err = AMP_DGC_SIGMAS * math.sqrt(
                        want * (1 - want) / n_s) + 1.0 / n_s
                    per[n] = [round(applied, 6), round(s_share, 6), n_s]
                    worst_sample.append((abs(s_share - want) * n_s, i, n))
                    if abs(applied - want) > random_err:
                        over_random.append(n)
                shares.append({"step": i, "want": want, "per_tensor":
                               per})
        finally:
            dgc_mod._threshold = real
        # timed unwatched, past the ramp
        ms = []
        for _ in range(AMP_DGC_TIMED):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            losses.append(float(step(ids)))
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
        rec[label] = {"losses": losses, "ms_per_step": ms,
                      "ms_per_step_median": sorted(ms)[len(ms) // 2]}
        if shares:
            rec[label]["applied_sample_n"] = shares
        del step, opt, model
        torch.cuda.empty_cache()
    worst_sample.sort(reverse=True)
    if worst_sample[0][0] > AMP_DGC_SAMPLE_SLACK:
        raise AssertionError(f"DGC: a sample's share off 1 - sparsity by "
                             f"more than {AMP_DGC_SAMPLE_SLACK} elements: "
                             f"{worst_sample[:4]}")
    if not all(map(math.isfinite, rec["DGCMomentum"]["losses"])):
        raise AssertionError(f"DGC losses: {rec['DGCMomentum']['losses']}")
    emit({"phase": "train_amp_dgc", "ok": True, "layers": AMP_DGC_LAYERS,
          "B": B, "S": S, "rampup_begin_step": AMP_DGC_BEGIN,
          "rampup_step": AMP_DGC_RAMP, "sparsity": AMP_DGC_SPARSITY,
          "sample_elements_off_max": worst_sample[0],
          "sample_slack": AMP_DGC_SAMPLE_SLACK,
          "applied_outside_random_sample_error": sorted(set(over_random)),
          "sigmas": AMP_DGC_SIGMAS, **rec})


def phase_train_amp(torch, dev, launches):
    """The rest of the training surface at GPT-1.3B's widths: (a) the
    bf16 O1 step under ``TrainStep`` (kernels against plain within the
    ``BF16_*`` limits, then ``multi_step``), (d) Lookahead and EMA over
    its steps, (b) the fp16 O1 recipe with ``GradScaler``, an inf planted
    in one step, then the fp16 single pass and folded backward at 4
    layers, (c) ``decorate(level="O2", dtype="float16")``, (e)
    ``DGCMomentum`` at 4 layers. Fills ``launches`` for the fp16
    records."""
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, BF16_VOCAB, (2, 2048), generator=gen, device=dev)
    amp_bf16_and_wrappers(torch, dev, ids)
    amp_fp16_scaler(torch, dev, ids, launches)
    amp_dgc(torch, dev, ids)


# -- phase 7 -----------------------------------------------------------------

RESNET_BATCH = 128      # tools/fused_eval_bench.py's batch
RESNET_REL_TOL = 1e-4   # logits, relative in L2, against the plain path
RESNET_FOLDS = 53       # conv+BN pairs of ResNet-50
RESNET_FUSED_BLOCKS = 5  # stride-1 identity blocks with H*W >= 784
# kernel-name substrings -> the group a forward's device time is summed
# under (first match wins)
RESNET_KERNEL_GROUPS = (
    ("fused_bottleneck", ("bottleneck_kernel",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "winograd",
                             "implicit", "fprop", "nchw", "nhwc")),
    ("pooling", ("pool",)),
    ("elementwise (BN, relu, add)", ("elementwise", "vectorized")),
    ("reductions", ("reduce",)),
)


def phase_resnet(torch, dev, launches):
    """ResNet-50 eval inference, NHWC, 1000 classes, 224x224, fp32 (TF32
    off), seed-0 weights and seeded BN running statistics (mean N(0,
    0.3), variance U(0.5, 2)), at N=128, on three paths over the same
    weights under ``torch.inference_mode()``: (a) the kernel path, opted
    in to the fused bottleneck; (b) the plain path, opted out (eager BN,
    cuDNN convolutions); (c) ``fuse_conv_bn`` on a deep copy."""
    import copy
    from paddle_tpu_torch.inference.fusion import fuse_conv_bn
    from paddle_tpu_torch.nn.norm import BatchNorm2D
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
    from paddle_tpu_torch.vision.models import resnet50
    t0 = time.monotonic()
    model = resnet50(data_format="NHWC", device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm2D):
                mod._mean.normal_(0.0, 0.3, generator=gen)
                mod._variance.uniform_(0.5, 2.0, generator=gen)
    folded = copy.deepcopy(model)
    folds = fuse_conv_bn(folded)
    if folds != RESNET_FOLDS:
        raise AssertionError(f"fuse_conv_bn folded {folds} pairs, not "
                             f"{RESNET_FOLDS}")
    x = torch.randn((RESNET_BATCH, 3, 224, 224), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    paths = {"kernel": (model, True), "plain": (model, False),
             "folded": (folded, False)}

    def forward(name, inp):
        m, fused = paths[name]
        FC.enable_fused_conv_eval(fused)
        try:
            with torch.inference_mode():
                return m(inp)
        finally:
            FC.enable_fused_conv_eval(False)

    logits, counts = {}, {}
    for name in paths:
        reset_launch_counts()
        logits[name] = forward(name, x)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
    for name, c in counts.items():
        want = RESNET_FUSED_BLOCKS if name == "kernel" else 0
        if c["fused_bottleneck"] != want:
            raise AssertionError(f"resnet {name} path: fused_bottleneck "
                                 f"launched {c['fused_bottleneck']} times "
                                 f"in one forward, not {want}")
        others = {k: v for k, v in c.items() if k != "fused_bottleneck"
                  and v}
        if others:
            raise AssertionError(f"resnet {name} path launched {others}")
    launches["fused_bottleneck"] = counts["kernel"]["fused_bottleneck"]
    plain = logits["plain"].float()
    rel = {}
    for name, out in logits.items():
        if tuple(out.shape) != (RESNET_BATCH, 1000) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"resnet {name} logits: shape "
                                 f"{tuple(out.shape)} or non-finite")
        rel[name] = float((out.float() - plain).norm() / plain.norm())
        note_share(f"resnet {name}", rel[name] / RESNET_REL_TOL)
        if not rel[name] <= RESNET_REL_TOL:
            raise AssertionError(f"resnet {name} path: logits {rel[name]:.3g}"
                                 f" relative off the plain path")
    top1 = {name: float((out.argmax(-1) == plain.argmax(-1)).float()
                        .mean()) for name, out in logits.items()}
    timer = Timer(torch, dev)
    timing = {}
    for name in paths:
        torch.cuda.reset_peak_memory_stats()
        ms = timer(lambda: forward(name, x), iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        ms1 = timer(lambda: forward(name, x[:1]), iters=10, warmup=2)
        timing[name] = {"ms_per_forward": ms,
                        "imgs_per_s": RESNET_BATCH / ms * 1e3,
                        "peak_mem_gb": peak / 1e9, "latency_ms_n1": ms1}
    prof = {name: profile_once(torch, lambda: forward(name, x),
                               RESNET_KERNEL_GROUPS)
            for name in ("kernel", "plain")}
    emit({"phase": "resnet", "ok": True, "model": "resnet50",
          "data_format": "NHWC", "batch": RESNET_BATCH, "image": 224,
          "dtype": "float32", "model_build_s": build_s, "folds": folds,
          "launches_per_forward": {n: c["fused_bottleneck"]
                                   for n, c in counts.items()},
          "tol_rel": RESNET_REL_TOL, "logits_rel_l2_vs_plain": rel,
          "top1_agreement_vs_plain": top1, "timing": timing,
          "profile": prof})


# -- phase 7b ----------------------------------------------------------------

# resnet_train: the JAX package's vision training benchmark, config 1
# (bench_all.py:83-145), uncut: ResNet-50, NCHW, 224x224, N=128, the
# bf16 recipe, labels in [0, 10), mean(cross_entropy(logits.float(), y)),
# Momentum(0.1, 0.9), TrainStep.multi_step over 16 stacked copies of one
# batch. The trained weights then run in eval, NHWC, on the
# fused-bottleneck kernel path and the plain path.
RT_STEPS = 16
RT_IMAGE = 224
RT_TIMED_CALLS = 2
RT_CLASSES = 10
RT_LR, RT_MOMENTUM = 0.1, 0.9
# 4.09 GFLOP a 224x224 forward (bench_all.py:136-139), x3 for a train step
RT_FLOPS_PER_IMAGE = 3 * 4.09e9
# bf16 trained eval, kernel against plain path: the kernel folds each BN
# into its conv's weights and rounds the folded weight to bf16 (u, with
# u = 2^-8), where the plain path rounds the conv's output before the BN
# (u); either output differs by up to 2u relative. 15 fused products (5
# blocks x 3) whose differences add as independent roundings give
# sqrt(15) * 2u ~ 8u over the logits, relative in L2.
RT_BF16_REL_TOL = 8 * BF16_U
# device time of a step by kernel group (first match wins): cuDNN's
# backward kernels name their pass (dgrad, wgrad), its forward ones fprop
# or the implicit-GEMM / winograd families
RT_KERNEL_GROUPS = (
    ("convolution backward", ("dgrad", "wgrad", "bprop", "backward")),
    ("convolution forward", ("fprop", "conv", "cudnn", "xmma", "winograd",
                             "implicit", "gemm", "nchw", "nhwc")),
    ("pooling", ("pool",)),
    ("BN, elementwise, reductions", ("elementwise", "vectorized", "reduce",
                                     "norm", "batch")),
)


def _vision_loss(m, b):
    """``mean(cross_entropy(logits.float(), y))``, the JAX bench's train
    function (``bench_all.py:113-116``)."""
    from paddle_tpu_torch.ops import nn_functional as NF
    return NF.cross_entropy(m(b[0]).float(), b[1]).mean()


def _step_split_ms(torch, step, batch):
    """One train step split by CUDA events into the device time of the
    forward, the backward and the optimizer update (``TrainStep._one``
    with events between its parts)."""
    from paddle_tpu_torch.core import rng
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model, opt = step.model, step.optimizer
    lr = opt.get_lr()
    torch.cuda.synchronize()
    model.train()
    opt.clear_grad()
    with rng.key_scope(step.generator):
        ev[0].record()
        loss = step.train_fn(model, batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
    opt._step(lr)
    ev[3].record()
    torch.cuda.synchronize()
    return {"forward": ev[0].elapsed_time(ev[1]),
            "backward": ev[1].elapsed_time(ev[2]),
            "optimizer": ev[2].elapsed_time(ev[3])}


def _trained_eval(torch, dev, state, x, bf16, timer):
    """The trained ``state`` in an NHWC ResNet-50 (fp32, or under the bf16
    recipe), eval, on the kernel path and the plain path: logits,
    ``fused_bottleneck`` launches a forward, ms a forward."""
    from paddle_tpu_torch.nn.layer import load_jax_state
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(data_format="NHWC", device=dev)
    if bf16:
        to_bf16_except_norms(torch, model)
    load_jax_state(model, state)
    model.eval()
    x = x.to(torch.bfloat16 if bf16 else torch.float32)

    def forward(fused):
        FC.enable_fused_conv_eval(fused)
        try:
            with torch.inference_mode():
                return model(x)
        finally:
            FC.enable_fused_conv_eval(False)

    out, counts = {}, {}
    for name, fused in (("kernel", True), ("plain", False)):
        reset_launch_counts()
        out[name] = forward(fused)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
    ms = {name: timer(lambda: forward(name == "kernel"), iters=5,
                      warmup=1) for name in ("kernel", "plain")}
    del model
    return out, counts, ms


def _checked_trained_evals(torch, dev, state, x, label):
    """``_trained_eval`` in fp32 and under the bf16 recipe, each held to
    its plain path (``RESNET_REL_TOL``, ``RT_BF16_REL_TOL``, relative in
    L2 over the logits) with exactly ``RESNET_FUSED_BLOCKS``
    ``fused_bottleneck`` launches a kernel forward and none a plain one.
    A failed closeness check goes to ``FAILED_CHECKS`` as
    ``{label} trained eval {tag}``; a wrong launch count raises."""
    timer = Timer(torch, dev)
    evals = {}
    for tag, bf16, tol in (("fp32", False, RESNET_REL_TOL),
                           ("bf16", True, RT_BF16_REL_TOL)):
        out, c, fwd_ms = _trained_eval(torch, dev, state, x, bf16, timer)
        for path, want in (("kernel", RESNET_FUSED_BLOCKS), ("plain", 0)):
            if c[path]["fused_bottleneck"] != want:
                raise AssertionError(
                    f"{label} trained eval {tag} {path}: fused_bottleneck "
                    f"launched {c[path]['fused_bottleneck']} times, not "
                    f"{want}")
            others = {k: v for k, v in c[path].items()
                      if k != "fused_bottleneck" and v}
            if others:
                raise AssertionError(f"{label} trained eval {tag} {path} "
                                     f"launched {others}")
        plain = out["plain"].float()
        got = out["kernel"].float()
        if not (torch.isfinite(got).all() and torch.isfinite(plain).all()):
            raise AssertionError(f"{label} trained eval {tag}: non-finite "
                                 f"logits")
        rel = float((got - plain).norm() / plain.norm())
        note_share(f"{label} trained eval {tag}", rel / tol)
        if not rel <= tol:
            FAILED_CHECKS.append(f"{label} trained eval {tag}: logits "
                                 f"{rel:.3g} relative off the plain path "
                                 f"(limit {tol:.3g})")
            emit({"check": f"{label}_trained_eval_{tag}", "ok": False,
                  "rel_l2": rel, "tol": tol})
        evals[tag] = {"rel_l2_vs_plain": rel, "tol_rel": tol,
                      "top1_agreement": float((got.argmax(-1) ==
                                               plain.argmax(-1)).float()
                                              .mean()),
                      "launches_per_forward": c["kernel"][
                          "fused_bottleneck"],
                      "ms_per_forward": fwd_ms}
    return evals


def phase_resnet_train(torch, dev):
    """Config 1 of the JAX vision benchmark uncut (see ``RT_*``): a warm
    ``multi_step`` (16 steps; finite losses, the last below the first on
    the same batch, no kernel of the port launched: every convolution is
    cuDNN's, as every one is XLA's in the JAX package), two timed calls
    (ms a step, imgs/s, peak memory, MFU against 989 TFLOP/s bf16 with
    the JAX bench's 3 x 4.09 GFLOP an image), a profiled step by kernel
    group and one split by CUDA events into forward, backward and
    optimizer. Then the trained weights in eval, NHWC, fp32 and bf16, on
    the fused-bottleneck path (5 launches a forward at N=128) against
    the plain path."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import checkpoint_state
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    t0 = time.monotonic()
    model = to_bf16_except_norms(torch, resnet50(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    keep = {n: str(p.dtype) for n, p in model.named_parameters()
            if "downsample.1" in n}
    gen = torch.Generator(device=dev).manual_seed(4)
    x32 = torch.randn((RESNET_BATCH, 3, RT_IMAGE, RT_IMAGE), generator=gen,
                      device=dev)
    y = torch.randint(0, RT_CLASSES, (RESNET_BATCH,), generator=gen,
                      device=dev)
    # one batch staged 16 times on the card, as the JAX bench stages it
    xs = x32.to(torch.bfloat16)[None].expand(
        RT_STEPS, *x32.shape).contiguous()
    ys = y[None].expand(RT_STEPS, RESNET_BATCH).contiguous()
    step = TrainStep(model, Momentum(learning_rate=RT_LR,
                                     momentum=RT_MOMENTUM), _vision_loss,
                     device=dev)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    reset_launch_counts()
    t0 = time.monotonic()
    losses = step.multi_step((xs, ys))
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    counts = launch_counts()
    losses = [float(v) for v in losses.float().tolist()]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"resnet_train losses do not fall: {losses}")
    if any(counts.values()):
        raise AssertionError(f"resnet_train launched port kernels: "
                             f"{ {k: v for k, v in counts.items() if v} }")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(RT_TIMED_CALLS):
        t0 = time.monotonic()
        more = step.multi_step((xs, ys))
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()
    more = [float(v) for v in more.float().tolist()]
    ms = min(walls) * 1e3 / RT_STEPS
    imgs_s = RESNET_BATCH / ms * 1e3
    prof = profile_once(torch, lambda: step((xs[0], ys[0])),
                        RT_KERNEL_GROUPS)
    split = _step_split_ms(torch, step, (xs[0], ys[0]))
    velocity = sorted({str(s["velocity"].dtype)
                       for s in step.optimizer._state.values()})
    state = checkpoint_state(model)
    stat_dtypes = sorted({str(b.dtype) for b in model.buffers()})
    del step, model, xs, ys
    torch.cuda.empty_cache()
    emit({"phase": "resnet_train", "ok": True, "model": "resnet50",
          "config": "bench_all.py config 1", "data_format": "NCHW",
          "batch": RESNET_BATCH, "image": RT_IMAGE, "classes": RT_CLASSES,
          "recipe": "bf16 except norms", "optimizer":
          f"Momentum({RT_LR}, {RT_MOMENTUM})", "steps_per_call": RT_STEPS,
          "downsample_bn_dtypes": sorted(set(keep.values())),
          "running_stat_dtypes": stat_dtypes, "velocity_dtypes": velocity,
          "build_s": build_s, "warm_call_s": warm_s, "losses": losses,
          "later_losses": more, "launches": counts,
          "timed_call_s": walls, "ms_per_step": ms, "imgs_per_s": imgs_s,
          "peak_mem_gb": peak / 1e9,
          "mfu": imgs_s * RT_FLOPS_PER_IMAGE / BF16_FLOPS,
          "step_split_ms": split, "step_profile": prof})

    evals = _checked_trained_evals(torch, dev, state, x32, "resnet")
    emit({"phase": "resnet_trained_eval", "ok": True, "model": "resnet50",
          "data_format": "NHWC", "batch": RESNET_BATCH, "image": RT_IMAGE,
          "weights": "resnet_train's, after its 48 steps", **evals})


# -- phase 7c ----------------------------------------------------------------

# vision_zoo: the rest of the zoo at full width, 224x224 (LeNet 28x28),
# seed-0 weights with seeded BN running statistics
ZOO_MODELS = (
    # name, constructor kwargs, batch, classes, conv+BN pairs fuse_conv_bn
    # folds, Momentum's rate (VGG16 without BN starts from logits of
    # ~10, and at 0.01 its steps overshoot)
    ("lenet", {}, 256, 10, 0, 0.01),
    ("mobilenet_v1", {}, 64, 1000, 27, 0.01),
    ("mobilenet_v2", {}, 64, 1000, 52, 0.01),
    ("vgg16", {}, 32, 1000, 0, 1e-4),
    ("vgg16_bn", {"batch_norm": True}, 32, 1000, 13, 1e-3),
)
ZOO_IMAGE = 224
ZOO_STEPS = 4
ZOO_REL_TOL = RESNET_REL_TOL


def _zoo_model(torch, dev, name, kw, data_format):
    from paddle_tpu_torch.vision import models as M
    gen = torch.Generator(device=dev).manual_seed(0)
    if name == "lenet":
        return M.LeNet(device=dev, generator=gen)
    make = getattr(M, name.replace("_bn", ""))
    return make(data_format=data_format, device=dev, generator=gen, **kw)


def phase_vision_zoo(torch, dev):
    """LeNet (B=256, 1x28x28), MobileNet v1 / v2 (N=64) and VGG16 /
    VGG16-BN (N=32), 224x224, fp32 (TF32 off): NCHW against NHWC on the
    same weights, ``fuse_conv_bn`` (the folds pinned in ``ZOO_MODELS``,
    as the CPU tests pin them) against the unfolded model, ms a forward
    and imgs/s, and ``ZOO_STEPS`` Momentum steps on one batch with the
    loss falling."""
    import copy
    from paddle_tpu_torch.inference.fusion import fuse_conv_bn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.norm import BatchNorm2D
    from paddle_tpu_torch.optimizer import Momentum
    timer = Timer(torch, dev)
    rows = {}
    for name, kw, batch, classes, want_folds, lr in ZOO_MODELS:
        t0 = time.monotonic()
        gen = torch.Generator(device=dev).manual_seed(5)
        shape = (batch, 1, 28, 28) if name == "lenet" else \
            (batch, 3, ZOO_IMAGE, ZOO_IMAGE)
        x = torch.randn(shape, generator=gen, device=dev)
        y = torch.randint(0, classes, (batch,), generator=gen, device=dev)
        model = _zoo_model(torch, dev, name, kw, "NCHW")
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm2D):
                    m._mean.normal_(0.0, 0.3, generator=gen)
                    m._variance.uniform_(0.5, 2.0, generator=gen)
        model.eval()
        row = {"batch": batch, "input": list(shape[1:])}
        with torch.no_grad():
            ref = model(x)
            if name != "lenet":
                nhwc = _zoo_model(torch, dev, name, kw, "NHWC")
                nhwc.load_state_dict(model.state_dict())
                nhwc.eval()
                got = nhwc(x)
                row["nhwc_rel_l2"] = float((got - ref).norm() / ref.norm())
                row["nhwc_ms_per_forward"] = timer(lambda: nhwc(x), iters=5,
                                                   warmup=1)
                del nhwc, got
            folded = copy.deepcopy(model)
            row["folds"] = fuse_conv_bn(folded)
            row["folded_rel_l2"] = float((folded(x) - ref).norm() /
                                         ref.norm())
            row["ms_per_forward"] = timer(lambda: model(x), iters=5,
                                          warmup=1)
            del folded
        if not torch.isfinite(ref).all() or tuple(ref.shape) != (batch,
                                                                  classes):
            raise AssertionError(f"{name}: logits {tuple(ref.shape)} or "
                                 f"non-finite")
        if row["folds"] != want_folds:
            raise AssertionError(f"{name}: fuse_conv_bn folded "
                                 f"{row['folds']} pairs, not {want_folds}")
        for key in ("nhwc_rel_l2", "folded_rel_l2"):
            if key in row:
                note_share(f"vision_zoo {name} {key}", row[key] / ZOO_REL_TOL)
            if key in row and not row[key] <= ZOO_REL_TOL:
                FAILED_CHECKS.append(f"vision_zoo {name}: {key} "
                                     f"{row[key]:.3g} over {ZOO_REL_TOL}")
                emit({"check": f"vision_zoo_{name}_{key}", "ok": False,
                      "rel_l2": row[key], "tol": ZOO_REL_TOL})
        row["imgs_per_s"] = batch / row["ms_per_forward"] * 1e3
        step = TrainStep(model, Momentum(learning_rate=lr, momentum=0.9),
                         _vision_loss, device=dev)
        losses = step.multi_step((x[None].expand(ZOO_STEPS, *shape),
                                  y[None].expand(ZOO_STEPS, batch)))
        losses = [float(v) for v in losses.tolist()]
        if not all(map(math.isfinite, losses)) or \
                not losses[-1] < losses[0]:
            FAILED_CHECKS.append(f"vision_zoo {name}: losses do not fall: "
                                 f"{losses}")
            emit({"check": f"vision_zoo_{name}_losses", "ok": False,
                  "losses": losses})
        row["train_losses"] = losses
        row["lr"] = lr
        row["seconds"] = time.monotonic() - t0
        rows[name] = row
        del step, model, ref
        torch.cuda.empty_cache()
    emit({"phase": "vision_zoo", "ok": True, "dtype": "float32",
          "tol_rel": ZOO_REL_TOL, "optimizer": "Momentum(lr, 0.9)",
          "steps": ZOO_STEPS, "models": rows})


# -- phase 7d ----------------------------------------------------------------

# vision_layers: each functional of slice 14 on the card (fp32, TF32 off)
# against the same call on the CPU in float64, on inputs drawn in fp32 (so
# float64 holds them exactly and a tie stays a tie): within 1e-5 of the
# largest magnitude; masks and max values exactly
VL_TOL = 1e-5


def _vision_layer_cases(F, VE):
    """(name, function, input shapes, options); an input named ``ties``
    is a ReLU output, full of zeros."""
    conv = dict(stride=2, padding=1)
    return (
        ("conv1d", F.conv1d, ((8, 16, 64), (32, 8, 3)), dict(
            padding=1, groups=2, data_format="NCL")),
        ("conv3d", F.conv3d, ((4, 8, 16, 16, 16), (16, 8, 3, 3, 3)), conv),
        ("conv2d_transpose", F.conv2d_transpose,
         ((8, 32, 28, 28), (32, 8, 3, 3)), dict(conv, groups=2,
                                                output_padding=1)),
        ("conv2d_transpose_nhwc", F.conv2d_transpose,
         ((8, 28, 28, 32), (32, 16, 4, 4)), dict(
             stride=2, padding=[1, 2, 2, 1], output_size=(57, 55),
             data_format="NHWC")),
        ("conv1d_transpose", F.conv1d_transpose,
         ((8, 16, 64), (16, 8, 5)), dict(stride=3, padding=2)),
        ("conv3d_transpose", VE.conv3d_transpose,
         ((4, 8, 8, 8, 8), (8, 4, 3, 3, 3)), dict(conv, output_padding=1)),
        ("max_pool2d_mask", F.max_pool2d, (("ties", 16, 32, 56, 56),),
         dict(kernel_size=3, stride=2, padding=1, return_mask=True)),
        ("max_pool2d_mask_nhwc", F.max_pool2d, (("ties", 16, 56, 56, 32),),
         dict(kernel_size=2, return_mask=True, data_format="NHWC")),
        ("max_pool1d_mask", F.max_pool1d, (("ties", 16, 32, 100),),
         dict(kernel_size=4, stride=2, padding=1, return_mask=True)),
        ("avg_pool1d", F.avg_pool1d, ((16, 32, 100),),
         dict(kernel_size=4, stride=2, padding=1)),
        ("max_pool3d", F.max_pool3d, ((4, 8, 16, 16, 16),),
         dict(kernel_size=3, stride=2, padding=1)),
        ("avg_pool3d", F.avg_pool3d, ((4, 8, 16, 16, 16),),
         dict(kernel_size=3, stride=2, padding=1)),
        ("adaptive_max_pool2d_mask", F.adaptive_max_pool2d,
         (("ties", 16, 32, 28, 28),), dict(output_size=7, return_mask=True)),
        ("adaptive_max_pool2d_general", F.adaptive_max_pool2d,
         ((16, 32, 28, 28),), dict(output_size=5)),
        ("adaptive_avg_pool1d", F.adaptive_avg_pool1d, ((16, 32, 100),),
         dict(output_size=7)),
        ("adaptive_max_pool1d_mask", F.adaptive_max_pool1d,
         (("ties", 16, 32, 100),), dict(output_size=10, return_mask=True)),
        ("adaptive_avg_pool3d", F.adaptive_avg_pool3d,
         ((4, 8, 16, 16, 16),), dict(output_size=(3, 5, 4))),
        ("adaptive_max_pool3d", F.adaptive_max_pool3d,
         ((4, 8, 16, 16, 16),), dict(output_size=4)),
        ("lp_pool2d", F.lp_pool2d, ((16, 32, 28, 28),),
         dict(norm_type=2, kernel_size=3, stride=2)),
        ("rms_norm", F.rms_norm, ((16, 128, 256), (256,)), {}),
        ("instance_norm", F.instance_norm, ((16, 32, 28, 28), (32,), (32,)),
         {}),
        ("group_norm_nhwc", F.group_norm, ((16, 28, 28, 32),),
         dict(num_groups=8, data_format="NHWC")),
        ("normalize", F.normalize, ((16, 32, 28, 28),), dict(p=3, axis=1)),
        ("local_response_norm", F.local_response_norm,
         ((16, 32, 28, 28),), dict(size=5)),
        ("relu6", F.relu6, ((64, 1024),), {}),
        ("selu", F.selu, ((64, 1024),), {}),
        ("mish", F.mish, ((64, 1024),), {}),
        ("hardswish", F.hardswish, ((64, 1024),), {}),
        ("softplus", F.softplus, ((64, 1024),), dict(beta=2.0)),
        ("softshrink", F.softshrink, ((64, 1024),), {}),
        ("log_softmax", F.log_softmax, ((64, 1024),), {}),
        ("maxout", F.maxout, ((16, 32, 28, 28),), dict(groups=4)),
        ("glu", F.glu, ((64, 1024),), {}),
        ("prelu", F.prelu, ((16, 32, 28, 28), (32,)), {}),
        ("thresholded_relu", F.thresholded_relu, ((64, 1024),), {}),
    )


def phase_vision_layers(torch, dev):
    """Each case of ``_vision_layer_cases`` on the card against the CPU in
    float64 (``VL_TOL``); ``max_unpool2d`` on the card's mask closes the
    round trip exactly."""
    from paddle_tpu_torch.ops import nn_functional as F
    from paddle_tpu_torch.ops import vision_extra as VE
    rows = {}
    for name, fn, shapes, kw in _vision_layer_cases(F, VE):
        gen = check_gen(torch, "cpu", name)
        ins = []
        for shape in shapes:
            ties = shape[0] == "ties"
            t = torch.randn(shape[1:] if ties else shape, generator=gen)
            ins.append(torch.relu(t) if ties else t)
        got = fn(*(t.to(dev) for t in ins), **kw)
        want = fn(*(t.double() for t in ins), **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = []
        for g, w in zip(got, want):
            g = g.cpu()
            if not g.is_floating_point() or name.startswith(
                    ("max_pool", "adaptive_max")):
                if not torch.equal(g.to(w.dtype), w):
                    FAILED_CHECKS.append(f"vision_layers {name}: not equal "
                                         f"to the float64 CPU result")
                    emit({"check": f"vision_layers_{name}", "ok": False,
                          "exact": True})
                errs.append(0.0 if torch.equal(g.to(w.dtype), w) else None)
            else:
                scale = max(float(w.abs().max()), 1e-30)
                errs.append(check_close(f"vision_layers {name}",
                                        g.double() / scale, w / scale,
                                        VL_TOL) * scale)
        rows[name] = {"max_abs_err": errs,
                      "shape": [list(g.shape) for g in got]}
    x = torch.relu(torch.randn((16, 32, 56, 56), generator=check_gen(
        torch, dev, "unpool"), device=dev))
    pooled, mask = F.max_pool2d(x, 2, return_mask=True)
    back = VE.max_unpool2d(pooled, mask, 2)
    roundtrip = bool(((back == 0) | (back == x)).all()) and bool(
        torch.equal(F.max_pool2d(back, 2), pooled))
    if not roundtrip:
        FAILED_CHECKS.append("vision_layers max_unpool2d: the round trip "
                             "did not restore the pooled maxima")
    emit({"phase": "vision_layers", "ok": True, "tol": VL_TOL,
          "tf32": False, "unpool_roundtrip": roundtrip, "cases": rows})


# -- phase 7e ----------------------------------------------------------------

# vision_folder: ResNet-50 at config 1 (as resnet_train) trained from an
# image folder through the port's transforms and io.DataLoader. The chip
# machine has no PIL, so the seeded images are uint8 HWC .npy files read
# by DatasetFolder(loader=np.load)
VF_CLASSES = 10
VF_IMAGES = 400
VF_SHORT = (240, 320)         # each image's short side; the long one up
VF_ASPECT = 4.0 / 3.0         # to 4/3 of it
VF_STEPS = 3
VF_WORKERS = 4
# the loader timed alone: batches drawn with replacement from the folder,
# 3 for each worker, so that its steady rate shows past the first wave
VF_LOADER_BATCHES = 3 * VF_WORKERS
VF_SEED = 21
VF_MEAN = (0.485, 0.456, 0.406)
VF_STD = (0.229, 0.224, 0.225)
VF_SMOOTHING = 0.1


def _write_image_folder(np, root):
    """``VF_IMAGES`` seeded uint8 HWC images, class ``i % VF_CLASSES``,
    as ``root/class_k/img_i.npy``; the tree is written anew each run.
    Returns the bytes written."""
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(VF_SEED)
    total = 0
    for c in range(VF_CLASSES):
        os.makedirs(os.path.join(root, f"class_{c}"))
    for i in range(VF_IMAGES):
        short = int(rng.integers(VF_SHORT[0], VF_SHORT[1] + 1))
        long = int(rng.integers(short, int(short * VF_ASPECT) + 1))
        hw = (short, long) if rng.random() < 0.5 else (long, short)
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        np.save(os.path.join(root, f"class_{i % VF_CLASSES}",
                             f"img_{i:04d}.npy"), img)
        total += img.nbytes
    return total


def phase_vision_folder(torch, dev):
    """The slice's path on the card: a ``DatasetFolder`` of ``.npy``
    images, ``Compose([RandomResizedCrop(224), RandomHorizontalFlip(),
    ToTensor(), Normalize(ImageNet)])`` and ``io.DataLoader(batch_size=128,
    shuffle=True, num_workers=4, drop_last=True)`` feed ResNet-50 under
    the bf16 recipe with ``Momentum(0.1, 0.9)`` and
    ``nn.CrossEntropyLoss(label_smoothing=0.1)`` for 3 steps (finite
    losses; no kernel of the port launched, as in resnet_train). The
    loader is timed alone over ``VF_LOADER_BATCHES`` batches of the same
    folder and transforms: its first batch's latency from a fresh
    iterator (cold) and its steady ms a batch after the first wave of
    ``VF_WORKERS`` batches. The 3 steps are then profiled on an iterator
    whose first batch has arrived (warm): each step's wait for its
    batch, its ms, and the device's idle share over the 3; the step
    waits on the loader in a long run when the steady ms a batch passes
    the step's. The trained weights then serve the
    eval transforms' batch (``Resize(256)``, ``CenterCrop(224)``,
    ``ToTensor``, ``Normalize``) on the NHWC eval path through
    ``fused_bottleneck``, against the plain path."""
    import numpy as np

    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import checkpoint_state
    from paddle_tpu_torch.nn.loss import CrossEntropyLoss
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import datasets
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import resnet50
    t_phase = time.monotonic()
    root = os.path.join(HERE, "build", "vision-folder")
    t0 = time.monotonic()
    written = _write_image_folder(np, root)
    write_s = time.monotonic() - t0
    np.random.seed(VF_SEED)       # the transforms' draws: numpy's stream
    folder = dict(loader=np.load, extensions=(".npy",))
    train = datasets.DatasetFolder(root, transform=T.Compose([
        T.RandomResizedCrop(RT_IMAGE), T.RandomHorizontalFlip(),
        T.ToTensor(), T.Normalize(VF_MEAN, VF_STD)]), **folder)
    loader = tio.DataLoader(train, places=dev, batch_size=RESNET_BATCH,
                            shuffle=True, num_workers=VF_WORKERS,
                            drop_last=True)
    if len(train) != VF_IMAGES or len(train.classes) != VF_CLASSES or \
            len(loader) != VF_STEPS:
        raise AssertionError(f"vision_folder: {len(train)} images in "
                             f"{len(train.classes)} classes, "
                             f"{len(loader)} batches")
    # (a) the loader alone: its first batch, and its steady rate
    timed = tio.DataLoader(train, places=dev, batch_sampler=tio.BatchSampler(
        sampler=tio.RandomSampler(train, replacement=True, num_samples=(
            VF_LOADER_BATCHES * RESNET_BATCH), generator=VF_SEED),
        batch_size=RESNET_BATCH, drop_last=True), num_workers=VF_WORKERS)
    shapes, arrived = set(), []
    t0 = time.monotonic()
    for x, y in timed:
        torch.cuda.synchronize()
        arrived.append((time.monotonic() - t0) * 1e3)
        shapes.add((tuple(x.shape), str(x.dtype), str(y.dtype),
                    str(x.device)))
    if len(arrived) != VF_LOADER_BATCHES:
        raise AssertionError(f"vision_folder: the timed loader gave "
                             f"{len(arrived)} batches")
    loader_first_ms = arrived[0]
    loader_steady_ms = (arrived[-1] - arrived[VF_WORKERS - 1]) / (
        VF_LOADER_BATCHES - VF_WORKERS)
    # (b) 3 train steps from the loader, profiled
    t0 = time.monotonic()
    model = to_bf16_except_norms(torch, resnet50(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    ce = CrossEntropyLoss(label_smoothing=VF_SMOOTHING)
    step = TrainStep(model, Momentum(learning_rate=RT_LR,
                                     momentum=RT_MOMENTUM),
                     lambda m, b: ce(m(b[0]).float(), b[1]), device=dev)
    torch.cuda.synchronize()
    model_s = time.monotonic() - t0
    waits, walls, losses = [], [], []
    it = iter(loader)
    t0 = time.monotonic()
    ready = [next(it)]
    torch.cuda.synchronize()
    first_wait_ms = (time.monotonic() - t0) * 1e3

    def three_steps():
        for _ in range(VF_STEPS):
            t0 = time.monotonic()
            x, y = ready.pop() if ready else next(it)
            t1 = time.monotonic()
            losses.append(step((x.to(torch.bfloat16), y)))
            torch.cuda.synchronize()
            waits.append((t1 - t0) * 1e3)
            walls.append((time.monotonic() - t0) * 1e3)

    reset_launch_counts()
    t0 = time.monotonic()
    prof = profile_once(torch, three_steps, RT_KERNEL_GROUPS,
                        host_ops=False)
    profile_s = time.monotonic() - t0
    counts = launch_counts()
    losses = [float(v) for v in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"vision_folder losses not finite: {losses}")
    if any(counts.values()):
        launched = {k: v for k, v in counts.items() if v}
        raise AssertionError(f"vision_folder training launched port "
                             f"kernels: {launched}")
    state = checkpoint_state(model)
    del step, model
    torch.cuda.empty_cache()
    # (c) the trained weights on the eval transforms' batch, NHWC, #11
    evalset = datasets.DatasetFolder(root, transform=T.Compose([
        T.Resize(256), T.CenterCrop(RT_IMAGE), T.ToTensor(),
        T.Normalize(VF_MEAN, VF_STD)]), **folder)
    t0 = time.monotonic()
    x_eval, y_eval = next(iter(tio.DataLoader(
        evalset, places=dev, batch_size=RESNET_BATCH,
        num_workers=VF_WORKERS)))
    torch.cuda.synchronize()
    eval_load_ms = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    evals = _checked_trained_evals(torch, dev, state, x_eval, "vision_folder")
    evals_s = time.monotonic() - t0
    emit({"phase": "vision_folder", "ok": True, "model": "resnet50",
          "config": "bench_all.py config 1", "data_format": "NCHW",
          "recipe": "bf16 except norms", "optimizer":
          f"Momentum({RT_LR}, {RT_MOMENTUM})",
          "loss": f"nn.CrossEntropyLoss(label_smoothing={VF_SMOOTHING})",
          "images": VF_IMAGES, "classes": VF_CLASSES,
          "short_side": list(VF_SHORT), "written_mb": written / 1e6,
          "write_s": write_s, "batch": RESNET_BATCH,
          "workers": VF_WORKERS, "batches": [list(s) for s in shapes],
          "loader_batches": VF_LOADER_BATCHES,
          "loader_arrival_ms": arrived,
          "loader_first_batch_ms": loader_first_ms,
          "loader_steady_ms_per_batch": loader_steady_ms,
          "loader_bound": loader_steady_ms > min(walls[1:]),
          "steps": VF_STEPS, "first_wait_ms_cold": first_wait_ms,
          "losses": losses, "wait_ms_warm": waits, "step_wall_ms": walls,
          "wait_share_warm": sum(waits) / sum(walls),
          "device_idle_share_warm": prof["idle_share"],
          "device_kernel_ms": prof["device_kernel_ms"],
          "profile_wall_ms": prof["wall_ms"],
          "by_group_ms": prof["by_group_ms"], "launches": counts,
          "eval_batch_load_ms": eval_load_ms,
          "eval_labels": sorted({int(v) for v in y_eval.tolist()}),
          "trained_eval": evals, "model_build_s": model_s,
          "profiled_steps_s": profile_s,
          "trained_evals_s": evals_s, "seconds": time.monotonic() - t_phase})


# vision_ops: the slice's functionals on the card against the same call
# on the CPU in float64 (integer outputs exactly); each within VO_TOL of
# the CPU result's largest magnitude unless the case names its own
VO_TOL = 1e-5
# cases that step at a bin edge (psroi_pool's bins take the pixels from
# floor(start) to ceil(end)): an f64 edge on an integer is an f32 edge an
# ulp to either side, so these hold the card's f32 against the CPU's f32
VO_CPU_F32 = frozenset({"psroi_pool"})


def _vo_probs(torch, g, shape):
    p = torch.rand(shape, generator=g) + 0.05
    return p / p.sum(-1, keepdim=True)


def _vision_ops_cases(torch, F, LE, VE, D):
    """(name, function, argument builder from a CPU generator, tolerance
    or None for ``VO_TOL``)."""
    r = torch.randn

    def ints(g, hi, shape, lo=0):
        return torch.randint(lo, hi, shape, generator=g)

    def signs(g, shape):
        return torch.where(torch.rand(shape, generator=g) < 0.5, -1.0, 1.0)

    def deform(g, masked, dg):
        off = torch.rand((4, 2 * dg * 9, 28, 28), generator=g) * 6 - 3
        mask = torch.rand((4, dg * 9, 28, 28), generator=g)
        return [r((4, 16, 28, 28), generator=g), off,
                r((32, 16, 3, 3), generator=g) * 0.1,
                mask if masked else None, r((32,), generator=g)]

    # integer RoIs (the first four: every edge of their 3 x 3 bins is an
    # integer) and fractional ones
    rois = torch.tensor([[0., 0., 24., 30.], [8., 4., 44., 40.],
                         [3., 6., 33., 27.], [-3., -3., 66., 51.],
                         [1.3, 2.6, 40.7, 30.4], [-4.2, -2.7, 60.9, 50.3],
                         [10.2, 5.1, 22.7, 39.9],
                         [30.1, 20.3, 30.6, 20.45]])
    gt_box = torch.tensor([[[0.5, 0.5, 0.3, 0.4], [0.2, 0.3, 0.1, 0.2]],
                           [[0.7, 0.2, 0.2, 0.1], [0.0, 0.0, 0.0, 0.0]]])
    anchors = [10, 13, 16, 30, 33, 23]
    cases = [
        ("cross_entropy_weighted", F.cross_entropy, lambda g: [
            r((256, 1000), generator=g), ints(g, 1000, (256,)),
            torch.rand((1000,), generator=g) + 0.5, 5, "mean", False, -1,
            True, 0.1], None),
        ("cross_entropy_soft", lambda x, y: F.cross_entropy(
            x, y, soft_label=True), lambda g: [
            r((128, 100), generator=g), _vo_probs(torch, g, (128, 100))],
         None),
        ("softmax_with_cross_entropy", F.softmax_with_cross_entropy,
         lambda g: [r((64, 100), generator=g), ints(g, 100, (64, 1))],
         None),
        ("nll_loss", F.nll_loss, lambda g: [
            torch.log(_vo_probs(torch, g, (256, 50))), ints(g, 50, (256,)),
            torch.rand((50,), generator=g) + 0.5], None),
        ("bce_with_logits", F.binary_cross_entropy_with_logits, lambda g: [
            r((64, 80), generator=g), (torch.rand((64, 80), generator=g)
                                       < 0.5).float()], None),
        ("kl_div", F.kl_div, lambda g: [
            torch.log(_vo_probs(torch, g, (64, 80))),
            _vo_probs(torch, g, (64, 80))], None),
        ("cosine_embedding_loss", F.cosine_embedding_loss, lambda g: [
            r((64, 128), generator=g), r((64, 128), generator=g),
            signs(g, (64,))], None),
        ("triplet_margin_loss", F.triplet_margin_loss, lambda g: [
            r((64, 128), generator=g), r((64, 128), generator=g),
            r((64, 128), generator=g)], None),
        ("sigmoid_focal_loss", F.sigmoid_focal_loss, lambda g: [
            r((64, 80), generator=g), (torch.rand((64, 80), generator=g)
                                       < 0.1).float()], None),
        ("multi_label_soft_margin_loss", F.multi_label_soft_margin_loss,
         lambda g: [r((64, 80), generator=g),
                    (torch.rand((64, 80), generator=g) < 0.5).float()],
         None),
        ("poisson_nll_loss", lambda x, y: F.poisson_nll_loss(
            x, y, full=True), lambda g: [
            r((64, 80), generator=g), torch.rand((64, 80), generator=g) * 5],
         None),
        ("gaussian_nll_loss", F.gaussian_nll_loss, lambda g: [
            r((64, 80), generator=g), r((64, 80), generator=g),
            torch.rand((64, 80), generator=g) + 0.1], None),
        ("ctc_loss", LE.ctc_loss, lambda g: [
            r((100, 16, 30), generator=g), ints(g, 30, (16, 20), 1),
            ints(g, 101, (16,), 60), ints(g, 21, (16,), 5)], 1e-4),
        ("hsigmoid_loss", lambda x, y, w, b: LE.hsigmoid_loss(
            x, y, w, b, num_classes=1000), lambda g: [
            r((64, 128), generator=g), ints(g, 1000, (64,)),
            r((999, 128), generator=g) * 0.1, r((999,), generator=g)],
         None),
    ]
    for mode, shape, fmt, sizes in (
            ("nearest", (8, 16, 56, 56), "NCHW", ((112, 100), (28, 20))),
            ("bilinear", (8, 16, 56, 56), "NCHW", ((112, 100), (28, 20))),
            ("bilinear", (8, 56, 56, 16), "NHWC", ((81, 97), (17, 23))),
            ("bicubic", (8, 16, 56, 56), "NCHW", ((112, 100), (28, 20))),
            ("area", (8, 16, 56, 56), "NCHW", ((28, 28),)),
            ("linear", (8, 16, 300), "NCW", ((512,), (77,))),
            ("trilinear", (2, 8, 16, 24, 24), "NCDHW", ((32, 40, 20),
                                                        (8, 9, 11)))):
        for size in sizes:
            tag = "x".join(map(str, size))
            cases.append((f"interpolate_{mode}_{fmt}_{tag}",
                          lambda x, m=mode, s=size, f=fmt: F.interpolate(
                              x, s, mode=m, data_format=f),
                          lambda g, sh=shape: [r(sh, generator=g)], None))
    cases += [
        ("interpolate_align_mode_1", lambda x: F.interpolate(
            x, (112, 41), mode="bilinear", align_mode=1),
         lambda g: [r((8, 16, 56, 56), generator=g)], None),
        # the sample position is an f32 value up to 55 (an ulp of 3.8e-6),
        # which moves each bilinear weight by as much (so in the RoI
        # pools and deformable_conv too)
        ("grid_sample_zeros", F.grid_sample, lambda g: [
            r((8, 16, 56, 56), generator=g),
            torch.rand((8, 40, 40, 2), generator=g) * 2.6 - 1.3], 1e-4),
        ("grid_sample_border_nearest", lambda x, gr: F.grid_sample(
            x, gr, "nearest", "border", False), lambda g: [
            r((8, 16, 56, 56), generator=g),
            torch.rand((8, 40, 40, 2), generator=g) * 2.6 - 1.3], None),
        ("affine_grid", lambda t: F.affine_grid(t, (8, 3, 64, 48), False),
         lambda g: [r((8, 2, 3), generator=g)], None),
        ("unfold", lambda x: F.unfold(x, 3, 2, 1), lambda g: [
            r((8, 16, 56, 56), generator=g)], None),
        ("fold", lambda x: F.fold(x, (56, 56), 3, 2, 1), lambda g: [
            r((8, 144, 784), generator=g)], None),
        ("pad3d_reflect", lambda x: F.pad3d(x, [1, 2, 2, 1, 1, 1],
                                            "reflect"),
         lambda g: [r((2, 8, 16, 24, 24), generator=g)], None),
        ("pad_circular", lambda x: F.pad(x, [2, 1, 3, 0], "circular"),
         lambda g: [r((8, 16, 56, 56), generator=g)], None),
        ("pixel_shuffle", lambda x: F.pixel_shuffle(x, 2), lambda g: [
            r((8, 64, 28, 28), generator=g)], None),
        ("pixel_unshuffle", lambda x: F.pixel_unshuffle(x, 2), lambda g: [
            r((8, 16, 56, 56), generator=g)], None),
        ("temporal_shift", lambda x: F.temporal_shift(x, 4), lambda g: [
            r((16, 32, 28, 28), generator=g)], None),
        ("channel_shuffle", lambda x: F.channel_shuffle(x, 4), lambda g: [
            r((8, 32, 28, 28), generator=g)], None),
        ("sequence_mask", lambda x: F.sequence_mask(x, 64), lambda g: [
            ints(g, 65, (32,))], None),
        ("one_hot", lambda x: F.one_hot(x, 1000), lambda g: [
            ints(g, 1000, (256,))], None),
        ("bilinear", F.bilinear, lambda g: [
            r((64, 32), generator=g), r((64, 48), generator=g),
            r((16, 32, 48), generator=g), r((16,), generator=g)], None),
        # offsets move each sample's bilinear weights as in grid_sample
        ("deformable_conv_v1", lambda x, o, w, m, b: VE.deformable_conv(
            x, o, w, m, b, 1, 1), lambda g: deform(g, False, 1), 1e-4),
        ("deformable_conv_v2", lambda x, o, w, m, b: VE.deformable_conv(
            x, o, w, m, b, 1, 1, 1, 2, 1), lambda g: deform(g, True, 2), 1e-4),
        ("psroi_pool", lambda x, rr: VE.psroi_pool(x, rr, 8, 1.0, 3, 3),
         lambda g: [r((1, 72, 48, 64), generator=g), rois], None),
        ("prroi_pool", lambda x, rr, n: VE.prroi_pool(x, rr, 0.5, 7, 7, n),
         lambda g: [r((2, 16, 48, 64), generator=g), rois * 2,
                    torch.tensor([3, 5])], 1e-4),
        ("spp", lambda x: VE.spp(x, 3), lambda g: [
            r((8, 16, 28, 28), generator=g)], None),
        ("correlation", lambda a, b: VE.correlation(a, b, 4, 1, 4),
         lambda g: [r((2, 32, 24, 32), generator=g),
                    r((2, 32, 24, 32), generator=g)], None),
        ("row_conv", VE.row_conv, lambda g: [
            r((8, 100, 64), generator=g), r((5, 64), generator=g)], None),
        ("yolov3_loss", lambda x, b, lab: VE.yolov3_loss(
            x, b, lab, anchors, [0, 1, 2], 80, 0.7, 32), lambda g: [
            r((2, 3 * 85, 13, 13), generator=g), gt_box,
            torch.tensor([[1, 2], [3, 0]])], 1e-4),
        ("yolo_box", lambda x, sz: D.yolo_box(x, sz, anchors, 80, 0.01, 32),
         lambda g: [r((2, 3 * 85, 13, 13), generator=g),
                    torch.tensor([[416, 416], [320, 480]])], None),
        ("yolo_box_iou_aware", lambda x, sz: D.yolo_box(
            x, sz, anchors, 80, 0.01, 32, iou_aware=True), lambda g: [
            r((2, 3 * 86, 13, 13), generator=g),
            torch.tensor([[416, 416], [320, 480]])], None),
    ]
    return cases


def phase_vision_ops(torch, dev):
    """Each case of ``_vision_ops_cases`` (the losses, the resampling
    ops, the vision extras and ``yolo_box`` of the slice) on the card in
    float32 against the CPU in float64 (in float32 for the cases of
    ``VO_CPU_F32``), within its tolerance of the CPU result's largest
    magnitude; ``shuffle_batch`` a permutation of the rows on the
    card."""
    from paddle_tpu_torch.ops import detection as D
    from paddle_tpu_torch.ops import loss_extra as LE
    from paddle_tpu_torch.ops import nn_functional as F
    from paddle_tpu_torch.ops import vision_extra as VE
    t0 = time.monotonic()
    rows = {}
    for name, fn, build, tol in _vision_ops_cases(torch, F, LE, VE, D):
        tol = VO_TOL if tol is None else tol
        args = build(check_gen(torch, "cpu", name))

        cpu_dtype = torch.float32 if name in VO_CPU_F32 else torch.float64

        def to(a, where):
            if not isinstance(a, torch.Tensor):
                return a
            if where == "cpu":
                return a.to(cpu_dtype) if a.is_floating_point() else a
            return a.to(dev)

        got = fn(*(to(a, "card") for a in args))
        want = fn(*(to(a, "cpu") for a in args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = []
        for g, w in zip(got, want):
            if g.device.type != "cuda":
                raise AssertionError(f"vision_ops {name}: the card's call "
                                     f"returned a {g.device} tensor")
            g = g.cpu()
            if not w.is_floating_point():
                same = torch.equal(g.to(w.dtype), w)
                if not same:
                    FAILED_CHECKS.append(f"vision_ops {name}: not equal to "
                                         f"the CPU result")
                    emit({"check": f"vision_ops_{name}", "ok": False,
                          "exact": True})
                errs.append(0.0 if same else None)
                continue
            w = w.double()
            scale = max(float(w.abs().max()), 1e-30)
            errs.append(check_close(f"vision_ops {name}", g.double() / scale,
                                    w / scale, tol) * scale)
        rows[name] = {"max_abs_err": errs, "tol_of_max": tol,
                      "cpu_dtype": str(cpu_dtype).replace("torch.", ""),
                      "shape": [list(g.shape) for g in got]}
    x = torch.arange(1024.0, device=dev).reshape(256, 4)
    gen = torch.Generator(device=dev).manual_seed(0)
    out, idx = VE.shuffle_batch(x, gen)
    perm = bool(torch.equal(idx.sort().values, torch.arange(256,
                                                            device=dev))
                and torch.equal(out, x[idx]))
    if not perm:
        FAILED_CHECKS.append("vision_ops shuffle_batch: not a row "
                             "permutation")
    emit({"phase": "vision_ops", "ok": True, "tol": VO_TOL, "tf32": False,
          "cases": rows, "shuffle_batch_permutation": perm,
          "seconds": time.monotonic() - t0})


# -- phase 8 -----------------------------------------------------------------

# bert_pretrain: the JAX package's benchmark config 2 (bench_all.py:
# 149-227): BERT-base MLM pretraining, B=64, S=512, 76 masked slots a
# sequence, dropout 0, AdamW(1e-4), the bf16 recipe; (a) holds fp32 at a
# smaller batch against the plain path
BERT_B = 64
BERT_S = 512
BERT_MASKED = 76              # max_predictions_per_seq
BERT_PARITY_B = 8
BERT_STEPS = 6
BERT_LR = 1e-4
# the kernels of BERT's self-attention (unmasked S=512: the folded gate)
BERT_KERNELS = ("attention_fwd", "folded_attention_bwd")
BERT_CLASSIFY_B = 8
# seq2seq_beam: Transformer-base (Vaswani et al. 2017, §5.1 and §6.1:
# a shared source-target vocabulary of about 37000, beam 4, at most the
# input length + 50 steps)
S2S_VOCAB = 37000
S2S_B = 8
S2S_SRC = 64
S2S_BEAM = 4
S2S_MAX_STEPS = S2S_SRC + 50
S2S_START, S2S_END = 1, 2
# each best hypothesis's score (fp32 sums of up to 114 log-probs near
# -10 over a 37000 vocabulary) against the teacher-forced sum: the two
# paths' logits come from products in other orders (~2e-5 a log-prob,
# 2.3e-3 over 114), and the score's 114 sequential fp32 additions of
# values up to ~1200 round by up to 114 * 1200 * 2^-24 ~ 8e-3
S2S_SCORE_ATOL = 1e-2


def bert_flops_per_token(model, cfg, seq: int, head_positions: int):
    """Executed training FLOPs a token of the BERT pretraining step (the
    port's copy of ``bench_all.py:230-251``
    ``bert_executed_flops_per_token``): 6 x the matmul parameters
    traversed (the encoder, the MLM transform and the tied vocabulary
    head, the last two scaled by the share of positions they run on)
    plus the attention's 12 x layers x hidden x seq. Embedding lookups
    and the pooler (one token a sequence) are not counted."""
    emb_names = ("embeddings.word_embeddings",
                 "embeddings.position_embeddings",
                 "embeddings.token_type_embeddings", "pooler")
    n_body = sum(p.numel() for name, p in model.named_parameters()
                 if not name.startswith(("mlm_", "nsp_"))
                 and not any(t in name for t in emb_names))
    h = cfg.hidden_size
    frac = head_positions / seq
    return (6.0 * n_body + 6.0 * (h * h + h + cfg.vocab_size * h) * frac
            + 12.0 * cfg.num_hidden_layers * h * seq)


def _bert_model(torch, dev, cls="BertForPretraining", **kw):
    """A seed-0 BERT-base with dropout 0 (``bench_all.py:159``)."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
    return getattr(bert, cls)(cfg, device=dev, **kw), cfg


def _bert_batch(torch, dev, vocab, B, S, K, seed):
    """ids [B, S], K distinct masked positions a row and their labels
    (the reference's gathered ``masked_lm_ids`` form)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, vocab, (B, S), generator=gen, device=dev)
    pos = torch.rand((B, S), generator=gen, device=dev).argsort(dim=1)[:, :K]
    return ids, pos, torch.gather(ids, 1, pos)


def _bert_fn(m, b):
    return m(b[0], masked_positions=b[1], labels=b[2])


def _bert_grads(torch, model, batch, plain: bool):
    """One forward+backward of the MLM loss through the kernels or their
    plain versions; returns (loss, {name: grad}, launch counts)."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    model.train()
    model.zero_grad(set_to_none=True)
    reset_launch_counts()
    with plain_kernels(plain):
        loss = _bert_fn(model, batch)
        loss.backward()
    torch.cuda.synchronize()
    # the pooler and the NSP head are off the MLM loss: no gradient
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, launch_counts()


def _key_bias_ratio(grads):
    """The key projections' bias gradients against their layers' query
    bias gradients, the largest ratio of norms. Softmax is invariant to
    the key bias, so its gradient is zero in exact arithmetic and its
    relative error says nothing; it is held to rounding size instead
    (``GRAD_REL_TOL`` of the query bias's)."""
    return max(float(g.float().norm()
                     / grads[n.replace("k_proj", "q_proj")].float().norm())
               for n, g in grads.items() if n.endswith("k_proj.bias"))


def bert_kernel_rows(torch, dev, records, per_step):
    """#9 and #10 at BERT-base's shape (B=64 S=512 H=12 D=64,
    non-causal, q, k and v as three projections' outputs) in fp32 and
    bf16: the folded forward and backward against their plain versions
    (fp32 ``ATTN_TOL`` / ``BWD_TOL``; bf16 before the rounding,
    ``BF16_ATOL``), timed beside the plain versions and SDPA, with their
    bounds and ``per_step``, the bench step's launches; added to the
    kernel records as rows of their own."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import attention as A
    timer = Timer(torch, dev)
    B, S, H, D = BERT_B, BERT_S, 12, 64
    out = []
    for dtype, tag, route in ((torch.float32, "fp32", "fp32"),
                              (torch.bfloat16, "bf16", "bf16")):
        gen = check_gen(torch, dev, f"bert attention {tag}")
        q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        isz = q.element_size()
        shape = f"B={B} S={S} H={H} D={D} non-causal {tag}"
        got = A.attention_fwd(q, k, v, return_lse=False)[0]
        grads = A.folded_attention_bwd(q, k, v, do)
        if dtype == torch.float32:
            want = A.attention_reference(q, k, v)[0]
            fwd_err = check_close(f"attention_fwd bert {tag}", got, want,
                                  ATTN_TOL)
            wants = A.folded_bwd_reference(q, k, v, do)
            bwd_err = max(check_close(f"folded_attention_bwd bert {tag} "
                                      f"{n}", g, w, BWD_TOL)
                          for n, g, w in zip("qkv", grads, wants))
        else:
            f32 = [t.float() for t in (q, k, v, do)]
            want = A.attention_reference(*f32[:3])[0]
            fwd_err = check_rounded_from(f"attention_fwd bert {tag}", got,
                                         want, BF16_ATOL["attention_fwd"])
            wants = A.folded_bwd_reference(*f32)
            bwd_err = max(check_rounded_from(
                f"folded_attention_bwd bert {tag} d{n}", g, w,
                BF16_ATOL["folded_attention_bwd"])
                for n, g, w in zip("qkv", grads, wants))
        del got, want, grads, wants
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fwd = dict(
            ms=timer(lambda: A.attention_fwd(q, k, v, return_lse=False)),
            plain_ms=timer(lambda: A.attention_reference(q, k, v)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt)), library="F.scaled_dot_product_attention")
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(
            4 * B * S * H * D * isz, 4 * B * H * D * S * S, route)
        del qt, kt, vt
        rd, wr, st = BWD_ROWS["folded_attention_bwd"]
        lib_ms, backend = _sdpa_bwd_ms(torch, timer, q, k, v, do, False)
        bwd = dict(
            ms=timer(lambda: A.folded_attention_bwd(q, k, v, do)),
            plain_ms=timer(lambda: A.folded_bwd_reference(q, k, v, do)),
            library_ms=lib_ms, library=f"SDPA backward ({backend})")
        bwd["bound_ms"], bwd["bound_by"] = bound_ms(
            (rd + wr) * B * S * H * D * isz + st * B * S * H * 4,
            BWD_FLOPS["folded_attention_bwd"] * B * H * S * S * D, route)
        for name, rec, err in (("attention_fwd", fwd, fwd_err),
                               ("folded_attention_bwd", bwd, bwd_err)):
            rec = dict(rec, shape=f"bert {shape}", max_abs_err=err,
                       launches_per_step=per_step[name])
            records[name].setdefault("per_shape", []).append(rec)
            out.append(dict(rec, kernel=name))
        del q, k, v, do
        torch.cuda.empty_cache()
    emit({"phase": "bert_kernels", "ok": True, "rows": out})


def phase_bert_pretrain(torch, dev, records):
    """BERT-base MLM pretraining (``bench_all.py:149-227``). (a) fp32,
    full width and depth, B=8, S=512, 76 masked slots: one
    forward+backward through the kernels against the plain path (loss
    within ``LOSS_REL_TOL``, every gradient within ``GRAD_REL_TOL`` in
    L2, the key biases' at rounding size), #9 and #10 launched once a
    layer on the kernel run and never on the plain run. (b) the bench
    config: B=64, the bf16 recipe, ``AdamW(1e-4)``, ``TrainStep.
    multi_step`` over ``BERT_STEPS`` steps: finite losses, ms a step,
    tokens/s, MFU against 989 TFLOP/s (``bert_flops_per_token``), peak
    memory, launches a step, one profiled step. Then #9 and #10 at the
    bench shape (``bert_kernel_rows``), each row with its launches a
    step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.monotonic()
    model, cfg = _bert_model(torch, dev)
    layers = cfg.num_hidden_layers
    batch = _bert_batch(torch, dev, cfg.vocab_size, BERT_PARITY_B, BERT_S,
                        BERT_MASKED, 3)
    loss_k, grads_k, counts_k = _bert_grads(torch, model, batch, False)
    loss_p, grads_p, counts_p = _bert_grads(torch, model, batch, True)
    errs = {n: e for n, e in _grad_rel(grads_k, grads_p).items()
            if not n.endswith("k_proj.bias")}
    key_bias = max(_key_bias_ratio(grads_k), _key_bias_ratio(grads_p))
    if not key_bias <= GRAD_REL_TOL:
        raise AssertionError(f"bert: key bias gradients at {key_bias:.3g}"
                             f" of the query biases'")
    rec = _check_train_parity("bert parity", loss_k, loss_p, errs)
    want = {name: layers for name in BERT_KERNELS}
    got = {name: counts_k[name] for name in BERT_KERNELS}
    if got != want or any(counts_p.values()):
        raise AssertionError(f"bert parity launches: kernel run {got} "
                             f"(want {want}), plain run {counts_p}")
    others = {n: c for n, c in counts_k.items()
              if c and n not in BERT_KERNELS}
    if others:
        raise AssertionError(f"bert parity: other kernels launched "
                             f"{others}")
    del grads_k, grads_p, model
    emit({"phase": "bert_parity", "ok": True, "model": "bert_base",
          "layers": layers, "B": BERT_PARITY_B, "S": BERT_S,
          "masked": BERT_MASKED, "dtype": "float32",
          "tol": {"loss_rel": LOSS_REL_TOL, "grad_rel": GRAD_REL_TOL},
          **rec, "key_bias_grad_vs_query_bias": key_bias,
          "launches_kernel_run": got,
          "launches_plain_run": {n: c for n, c in counts_p.items() if c},
          "grad_rel": {n: float(f"{e:.3g}") for n, e in errs.items()}})
    torch.cuda.empty_cache()

    model, cfg = _bert_model(torch, dev)
    to_bf16_except_norms(torch, model)
    batch = _bert_batch(torch, dev, cfg.vocab_size, BERT_B, BERT_S,
                        BERT_MASKED, 4)
    step = TrainStep(model, AdamW(learning_rate=BERT_LR), _bert_fn, seed=0,
                     device=dev)
    first = float(step(batch))  # warm-up step: Adam slots allocated here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t1 = time.monotonic()
    losses = step.multi_step(tuple(t[None].expand((BERT_STEPS,) + t.shape)
                                   for t in batch))
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses.float().tolist()]
    if not all(map(math.isfinite, losses + [first])):
        raise AssertionError(f"bert losses: {first} {losses}")
    per_step = {n: c / BERT_STEPS for n, c in counts.items() if c}
    for name in BERT_KERNELS:
        if per_step.get(name) != layers:
            raise AssertionError(f"bert step: {name} launched "
                                 f"{per_step.get(name)} times a step, not "
                                 f"{layers}")
    prof = profile_once(torch, lambda: step(batch))
    ms = wall * 1e3 / BERT_STEPS
    tok_s = BERT_B * BERT_S * BERT_STEPS / wall
    flops_tok = bert_flops_per_token(model, cfg, BERT_S, BERT_MASKED)
    emit({"phase": "bert_pretrain", "ok": True, "model": "bert_base",
          "layers": layers, "B": BERT_B, "S": BERT_S,
          "masked": BERT_MASKED, "recipe": "bf16 except norms",
          "optimizer": f"AdamW({BERT_LR})", "warmup_loss": first,
          "losses": losses, "ms_per_step": ms, "tokens_per_s": tok_s,
          "flops_per_token": flops_tok,
          "mfu": tok_s * flops_tok / BF16_FLOPS,
          "peak_mem_gb": peak / 1e9, "launches_per_step": per_step,
          "step_profile": prof})
    del step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    bert_kernel_rows(torch, dev, records, per_step)
    emit({"phase": "bert_pretrain_wall", "seconds": time.monotonic() - t0})


def phase_bert_classify(torch, dev):
    """``BertForSequenceClassification`` (BERT-base, seed 0, eval),
    B=8, S=512: with a padding mask (rows of 512 down to 288 tokens) it
    takes the plain math, through the kernels' selection and under
    ``plain_kernels()`` alike, bitwise; without a mask the folded kernel
    (#9, once a layer), its logits within ``MODEL_REL_TOL`` of the plain
    path's and of an all-ones mask's."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    t0 = time.monotonic()
    model, cfg = _bert_model(torch, dev, "BertForSequenceClassification")
    model.eval()
    B, S = BERT_CLASSIFY_B, BERT_S
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                        device=dev)
    lens = torch.tensor([S - 32 * i for i in range(B)], device=dev)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]).long()
    runs = {}
    for tag, m, plain in (("masked", mask, False),
                          ("masked_plain", mask, True),
                          ("unmasked", None, False),
                          ("unmasked_plain", None, True),
                          ("all_ones_mask", torch.ones_like(mask), False)):
        reset_launch_counts()
        with torch.inference_mode(), plain_kernels(plain):
            logits = model(ids, attention_mask=m)
        torch.cuda.synchronize()
        if tuple(logits.shape) != (B, 2) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"bert classify {tag}: logits "
                                 f"{tuple(logits.shape)}")
        runs[tag] = (logits, launch_counts()["attention_fwd"])
    fwd = {tag: n for tag, (_, n) in runs.items()}
    if fwd != {"masked": 0, "masked_plain": 0,
               "unmasked": cfg.num_hidden_layers, "unmasked_plain": 0,
               "all_ones_mask": 0}:
        raise AssertionError(f"bert classify attention_fwd launches {fwd}")
    if not torch.equal(runs["masked"][0], runs["masked_plain"][0]):
        raise AssertionError("bert classify: the masked run differs from "
                             "its plain run")
    rel = {tag: rel_err(runs["unmasked"][0], runs[tag][0])
           for tag in ("unmasked_plain", "all_ones_mask")}
    for tag, r in rel.items():
        if not r <= MODEL_REL_TOL:
            raise AssertionError(f"bert classify: kernel logits {r:.3g} "
                                 f"relative off the {tag} run")
    emit({"phase": "bert_classify", "ok": True, "model": "bert_base",
          "B": B, "S": S, "lengths": lens.tolist(),
          "attention_fwd_launches": fwd, "tol_rel": MODEL_REL_TOL,
          "kernel_logits_rel": rel, "masked_plain_bitwise": True,
          "seconds": time.monotonic() - t0})
    del model, runs
    torch.cuda.empty_cache()


# export: the JAX package's benchmark config 5 (bench_all.py:3304-3366),
# the AOT predictor's serving latency: n_runs on the chip, a pipelined
# window of max(32, n_runs) and a device window of 3x that
EXPORT_RUNS = 100
EXPORT_PIPE = max(32, EXPORT_RUNS)
EXPORT_DEV = 3 * EXPORT_PIPE
EXPORT_FLOOR_RUNS = max(10, EXPORT_RUNS // 5)
EXPORT_BERT_S = 128         # config 5's BERT: under the folded crossover
EXPORT_BERT_LONG = 512      # BERT-base at S=512: the folded kernel (#9)
EXPORT_DIR = os.path.join(HERE, "build", "export")
EXPORT_KERNEL_OPS = {"attention_fwd": "paddle_tpu_torch.attention_fwd",
                     "fused_bottleneck": "paddle_tpu_torch.fused_bottleneck"}
# device time of a profiled predictor run, by kernel-name substring
EXPORT_KERNEL_GROUPS = (
    ("attention_fwd", ("attention_fwd",)),
    ("fused_bottleneck", ("bottleneck_kernel",)),
    # cuDNN's convolutions are implicit GEMMs: matched before the GEMMs
    ("convolution (cuDNN)", ("fprop", "conv", "cudnn", "implicit",
                             "winograd", "nchw", "nhwc")),
    ("gemm", ("gemm", "sm90", "cutlass", "xmma")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reductions, norms", ("reduce", "norm", "softmax")),
)


def _dispatch_floor_ms(torch, dev):
    """p50 of a trivial launch and host fetch (``bench_all.py:3319-3329``:
    ``float(v + 1)`` on a device scalar)."""
    import numpy as np
    z = torch.zeros((), device=dev)
    float(z + 1.0)
    floor = []
    for _ in range(EXPORT_FLOOR_RUNS):
        t0 = time.perf_counter()
        float(z + 1.0)
        floor.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(floor, 50))


def _serve_latency(torch, pred, inputs, floor_ms):
    """The JAX harness's serving keys (``bench_all.py:3224-3301``) on a
    port predictor: inputs staged on the card once (its
    ``share_external_data`` pattern), per-request wall ms with the host
    fetch (``run`` with inputs returns numpy), then the inputs bound to
    the handles and ``run()`` back to back with one synchronise at the
    end of a window of ``EXPORT_PIPE`` (pipelined) and ``EXPORT_DEV``
    (device) requests. A loaded program runs op by op, so these windows
    are paced by the host; the profiled run's device kernel ms says how
    much of a request the card is busy."""
    import numpy as np
    inputs = [pred._to_input(n, a)
              for n, a in zip(pred.get_input_names(), inputs)]
    pred.run(inputs)
    lat = []
    for _ in range(EXPORT_RUNS):
        t0 = time.perf_counter()
        pred.run(inputs)
        lat.append((time.perf_counter() - t0) * 1e3)
    for n, a in zip(pred.get_input_names(), inputs):
        pred.get_input_handle(n).share_external_data(a)
    pred.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EXPORT_PIPE):
        pred.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(EXPORT_DEV):
        pred.run()
    torch.cuda.synchronize()
    dt_dev = time.perf_counter() - t0
    prof = profile_once(torch, pred.run, EXPORT_KERNEL_GROUPS,
                        host_ops=False)
    p50 = float(np.percentile(lat, 50))
    return {"p50_wall_ms": p50, "p99_wall_ms": float(np.percentile(lat, 99)),
            "p50_above_floor_ms": max(0.0, p50 - floor_ms),
            "pipelined_requests_per_s": EXPORT_PIPE / dt,
            "pipelined_ms_per_req": dt / EXPORT_PIPE * 1e3,
            "device_ms_per_req": dt_dev / EXPORT_DEV * 1e3,
            "floor_ms_subtracted": floor_ms, "runs": EXPORT_RUNS,
            "pipelined_runs": EXPORT_PIPE, "device_window_runs": EXPORT_DEV,
            "profiled_run": {k: prof[k] for k in (
                "wall_ms", "device_kernel_ms", "kernels", "idle_share",
                "by_group_ms")}}


def _graph_kernel_ops(pred):
    """Kernel op nodes in a loaded program's graph, by kernel."""
    names = [str(n.target) for n in pred._program.exported.graph.nodes
             if n.op == "call_function"]
    return {k: sum(op in n for n in names)
            for k, op in EXPORT_KERNEL_OPS.items()}


def _export_run(torch, pred, inputs):
    """One predictor run with the launch counts set to 0 just before and
    read just after: (outputs as tensors on the card, launch counts)."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    for n, a in zip(pred.get_input_names(), inputs):
        pred.get_input_handle(n).copy_from_cpu(a)
    reset_launch_counts()
    pred.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    outs = [pred._outputs[n] for n in pred.get_output_names()]
    return outs, counts


def _export_check(phase, name, got, want, tol, rel=None):
    """A closeness check of the phase: ``rel_err`` (max over max) unless
    ``rel`` is given (relative in L2); a failure goes to
    ``FAILED_CHECKS``."""
    err = rel_err(got, want) if rel is None else rel
    note_share(f"{phase} {name}", err / tol)
    if not err <= tol:
        FAILED_CHECKS.append(f"{phase} {name}: {err:.3g} relative off "
                             f"(limit {tol:.3g})")
        emit({"check": f"{phase}_{name}", "ok": False, "rel": err,
              "tol": tol})
    return err


def _launch_gate(phase, name, counts, want):
    """Exactly ``want`` launches of each named kernel and none of any
    other kernel; else the phase raises."""
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{phase} {name}: launches {bad}, want {want}")


def phase_export(torch, dev, card):
    """Saved programs through ``inference.Predictor`` (see the module
    docstring, 8c): config 5 as the JAX benchmark defines it, then the
    two programs that reach the registered kernels (BERT-base S=512, #9
    once a layer; ResNet-50 NHWC opted in, #11 on five blocks), then
    bf16 storage and the device rule."""
    import shutil
    import numpy as np
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.nn.norm import BatchNorm2D
    from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    from paddle_tpu_torch.static import InputSpec, save_inference_model
    from paddle_tpu_torch.vision.models import resnet50
    phase = "export"
    t0 = time.monotonic()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    out = {"phase": phase, "card": card}
    rng = np.random.default_rng(0)
    floor = _dispatch_floor_ms(torch, dev)
    out["dispatch_floor_ms"] = floor

    def saved(prefix, model, spec, **kw):
        t = time.monotonic()
        save_inference_model(os.path.join(EXPORT_DIR, prefix), [spec],
                             layer=model, **kw)
        return time.monotonic() - t

    def predictor(prefix, precision=None):
        cfg = Config(os.path.join(EXPORT_DIR, prefix))
        if precision:
            cfg.set_precision(precision)
        return create_predictor(cfg)

    def eager(model, x):
        with torch.inference_mode():
            return model(torch.as_tensor(x, device=dev))

    # (a) config 5: ResNet-50 fp32 NCHW with optimize=True, BERT-base S=128
    rmodel = resnet50(device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    rmodel.eval()
    rx = rng.standard_normal((1, 3, 224, 224)).astype(np.float32)
    export_s = {"resnet": saved("resnet", rmodel, InputSpec(
        (1, 3, 224, 224), "float32", "x"))}
    bcfg = bert.bert_base(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    bmodel = bert.BertForSequenceClassification(bcfg, device=dev)
    bmodel.eval()
    bx = rng.integers(0, bcfg.vocab_size, (1, EXPORT_BERT_S)).astype(
        np.int32)
    export_s["bert"] = saved("bert", bmodel, InputSpec(
        (1, EXPORT_BERT_S), "int32", "input_ids"))
    config5 = {}
    for name, model, x in (("resnet", rmodel, rx), ("bert", bmodel, bx)):
        pred = predictor(name)
        (logits,), counts = _export_run(torch, pred, [x])
        want = eager(model, x)
        if tuple(logits.shape) != tuple(want.shape) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{phase} {name}: logits "
                                 f"{tuple(logits.shape)} or non-finite")
        _launch_gate(phase, name, counts, {})
        err = _export_check(phase, name, logits, want, MODEL_REL_TOL)
        config5[name] = {"logits_rel_vs_eager": err,
                         "graph_kernel_ops": _graph_kernel_ops(pred),
                         "launches_per_run": {k: v for k, v in
                                              counts.items() if v},
                         "export_s": export_s[name],
                         **_serve_latency(torch, pred, [x], floor)}
        del pred
    out["config5"] = config5
    emit({"phase": "export_config5", "card": card,
          "dispatch_floor_ms": floor, **config5})

    # (b) BERT-base, N=1, S=512: the folded forward (#9) once a layer
    lx = rng.integers(0, bcfg.vocab_size, (1, EXPORT_BERT_LONG)).astype(
        np.int32)
    long_s = saved("bert512", bmodel, InputSpec(
        (1, EXPORT_BERT_LONG), "int32", "input_ids"))
    pred = predictor("bert512")
    (logits,), counts = _export_run(torch, pred, [lx])
    _launch_gate(phase, "bert512", counts,
                 {"attention_fwd": bcfg.num_hidden_layers})
    with plain_kernels():
        want = eager(bmodel, lx)
    ops = _graph_kernel_ops(pred)
    if ops["attention_fwd"] != bcfg.num_hidden_layers:
        raise AssertionError(f"{phase} bert512: graph holds {ops}")
    out["bert512"] = {
        "logits_rel_vs_plain": _export_check(phase, "bert512", logits,
                                             want, MODEL_REL_TOL),
        "graph_kernel_ops": ops, "launches_per_run": {
            k: v for k, v in counts.items() if v},
        "export_s": long_s, **_serve_latency(torch, pred, [lx], floor)}
    del pred

    # (d) bf16 storage against fp32 over parameters rounded to bf16, and
    # the device rule (on BERT S=128)
    low = predictor("bert", "bfloat16")
    (got,), _ = _export_run(torch, low, [bx])
    ref = predictor("bert")
    with torch.no_grad():
        for v in ref._program.params.values():
            if v.is_floating_point():
                v.copy_(v.to(torch.bfloat16).to(v.dtype))
    (want,), _ = _export_run(torch, ref, [bx])
    out["bf16_storage"] = {"rel_vs_rounded_fp32": _export_check(
        phase, "bf16 storage", got, want, MODEL_REL_TOL),
        "bitwise": bool(torch.equal(got, want))}
    del low, ref
    cfg = Config(os.path.join(EXPORT_DIR, "bert"))
    cfg.disable_gpu()
    try:
        create_predictor(cfg)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    if refused is None or "cuda" not in refused or "cpu" not in refused:
        FAILED_CHECKS.append(f"{phase}: a card program under disable_gpu() "
                             f"was not refused naming both devices "
                             f"({refused})")
    out["disable_gpu_refused"] = refused
    del rmodel, bmodel
    torch.cuda.empty_cache()

    # (c) ResNet-50 NHWC, N=1, opted in: #11 on five blocks
    model = resnet50(data_format="NHWC", device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm2D):
                mod._mean.normal_(0.0, 0.3, generator=gen)
                mod._variance.uniform_(0.5, 2.0, generator=gen)
    nx = rng.standard_normal((1, 3, 224, 224)).astype(np.float32)
    FC.enable_fused_conv_eval(True)
    try:
        nhwc_s = saved("resnet_nhwc", model, InputSpec(
            (1, 3, 224, 224), "float32", "x"), optimize=False)
    finally:
        FC.enable_fused_conv_eval(False)
    packs = [m._fused_pack for m in model.modules()
             if hasattr(m, "_fused_pack")]
    if any(p is not None for p in packs):
        raise AssertionError(f"{phase} resnet_nhwc: the export stored a "
                             f"traced pack on the model")
    pred = predictor("resnet_nhwc")
    (logits,), counts = _export_run(torch, pred, [nx])
    _launch_gate(phase, "resnet_nhwc", counts,
                 {"fused_bottleneck": RESNET_FUSED_BLOCKS})
    plain = eager(model, nx).float()
    ops = _graph_kernel_ops(pred)
    if ops["fused_bottleneck"] != RESNET_FUSED_BLOCKS:
        raise AssertionError(f"{phase} resnet_nhwc: graph holds {ops}")
    rel = float((logits.float() - plain).norm() / plain.norm())
    out["resnet_nhwc"] = {
        "logits_rel_l2_vs_plain": _export_check(
            phase, "resnet_nhwc", logits, plain, RESNET_REL_TOL, rel=rel),
        "tol_rel": RESNET_REL_TOL, "graph_kernel_ops": ops,
        "launches_per_run": {k: v for k, v in counts.items() if v},
        "export_s": nhwc_s, **_serve_latency(torch, pred, [nx], floor)}
    del pred, model
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    out["tol_rel"] = MODEL_REL_TOL
    out["seconds"] = time.monotonic() - t0
    emit(out)


def _sinusoid(torch, n, d, dev):
    """Vaswani et al.'s positional encodings, [n, d]."""
    pos = torch.arange(n, device=dev, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=dev, dtype=torch.float32)
                    * (-math.log(10000.0) / d))
    out = torch.zeros((n, d), device=dev)
    out[:, 0::2] = torch.sin(pos * div)
    out[:, 1::2] = torch.cos(pos * div)
    return out


class Seq2SeqCell:
    """Transformer-base's decoder as a beam-search cell (this script's
    code, not a package feature): the states are the encoder memory and
    each layer's self-attention ``MultiHeadAttention.Cache`` as a ``(k,
    v)`` tuple, batch first, so the search tiles and reorders them; the
    input is the shared embedding plus the position of the cache
    length; the output projects onto the vocabulary through the shared
    embedding matrix (Vaswani et al. §3.4) over sqrt(d_model), the
    scale the embedding layers apply to its unscaled form."""

    def __init__(self, torch, model, emb, table):
        from paddle_tpu_torch.nn.transformer import MultiHeadAttention
        self.torch, self.decoder, self.emb = torch, model.decoder, emb
        self.table, self.cache = table, MultiHeadAttention.Cache
        self.scale = 1.0 / math.sqrt(model.d_model)

    def logits(self, h):
        return self.torch.matmul(h, self.emb.weight.t()) * self.scale

    def __call__(self, x, states):
        memory, caches = states
        pos = caches[0][0].shape[1]
        x = (x + self.table[pos])[:, None]
        out, new = self.decoder(x, memory, cache=[
            (self.cache(k, v),) for k, v in caches])
        return out[:, 0], (memory, tuple((c[0].k, c[0].v) for c in new))


def phase_seq2seq_beam(torch, dev):
    """Transformer-base (``Transformer()`` at its defaults, seed 0,
    eval), a shared vocabulary of 37000, beam 4: 8 source sentences of
    64 tokens encoded, then ``BeamSearchDecoder`` + ``dynamic_decode``
    over ``Seq2SeqCell`` for at most 64 + 50 steps. Check: each best
    hypothesis's score within ``S2S_SCORE_ATOL`` of the sum of its token
    log-probs from one teacher-forced, uncached decoder forward under
    ``generate_square_subsequent_mask``, the cached incremental path
    against the full one. At these lengths (64 keys, one query a step,
    a mask in the teacher-forced pass) the JAX package's crossovers
    send every attention to the plain math, so no kernel launches; the
    count is printed. Reports ms a decode step, steps and tokens/s."""
    from paddle_tpu_torch.nn.common import Embedding
    from paddle_tpu_torch.nn.decode import BeamSearchDecoder, dynamic_decode
    from paddle_tpu_torch.nn.transformer import Transformer
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    t0 = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Transformer(device=dev, generator=gen).eval()
    d = model.d_model
    emb = Embedding(S2S_VOCAB, d, device=dev, generator=gen)
    table = _sinusoid(torch, S2S_MAX_STEPS + 1, d, dev)
    cell = Seq2SeqCell(torch, model, emb, table)
    src = torch.randint(3, S2S_VOCAB, (S2S_B, S2S_SRC), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    reset_launch_counts()
    with torch.inference_mode():
        t1 = time.monotonic()
        memory = model.encoder(emb(src) + table[:S2S_SRC])
        caches = tuple((c[0].k, c[0].v)
                       for c in model.decoder.gen_cache(memory))
        torch.cuda.synchronize()
        encode_s = time.monotonic() - t1
        dec = BeamSearchDecoder(cell, start_token=S2S_START,
                                end_token=S2S_END, beam_size=S2S_BEAM,
                                embedding_fn=emb, output_fn=cell.logits)
        t1 = time.monotonic()
        ids, scores, lengths = dynamic_decode(
            dec, inits=(memory, caches), max_step_num=S2S_MAX_STEPS,
            return_length=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
        counts = {n: c for n, c in launch_counts().items() if c}
        steps = ids.shape[1]
        # teacher-forced: [start, y_1 .. y_{T-1}] at positions 0 .. T-1
        tgt = torch.cat([torch.full((S2S_B, 1), S2S_START, device=dev,
                                    dtype=ids.dtype), ids[:, :-1]], dim=1)
        mask = Transformer.generate_square_subsequent_mask(steps,
                                                           device=dev)
        h = model.decoder(emb(tgt) + table[:steps], memory, tgt_mask=mask)
        logp = torch.log_softmax(cell.logits(h).float(), dim=-1)
        tok_logp = torch.gather(logp, 2, ids.long()[..., None])[..., 0]
        # a finished beam carries its score: count up to its first end
        upto = torch.arange(steps, device=dev)[None, :] <= \
            lengths.long()[:, None]
        forced = (tok_logp * upto).sum(dim=1)
    if tuple(ids.shape) != (S2S_B, steps) or \
            not torch.isfinite(scores).all():
        raise AssertionError(f"seq2seq: ids {tuple(ids.shape)}, scores "
                             f"{scores.tolist()}")
    err = float((scores - forced).abs().max())
    if not err <= S2S_SCORE_ATOL:
        raise AssertionError(f"seq2seq: best scores {scores.tolist()} vs "
                             f"teacher-forced {forced.tolist()} (max abs "
                             f"err {err:.3g})")
    emit({"phase": "seq2seq_beam", "ok": True, "model": "Transformer()",
          "d_model": d, "layers": "6+6", "vocab": S2S_VOCAB, "B": S2S_B,
          "src_len": S2S_SRC, "beam": S2S_BEAM,
          "max_step_num": S2S_MAX_STEPS, "steps": steps,
          "lengths": lengths.tolist(), "scores": scores.tolist(),
          "score_max_abs_err_vs_teacher_forced": err,
          "tol_abs": S2S_SCORE_ATOL, "kernel_launches": counts,
          "attention": "plain math at these lengths (JAX crossovers)",
          "build_s": build_s, "encode_s": encode_s, "decode_s": wall,
          "ms_per_decode_step": wall * 1e3 / steps,
          "hypothesis_tokens_per_s": S2S_B * steps / wall,
          "beam_tokens_per_s": S2S_B * S2S_BEAM * steps / wall,
          "seconds": time.monotonic() - t0})
    del model, emb, memory, caches
    torch.cuda.empty_cache()


# each phase's wall seconds, by function name, emitted before "wall"
PHASE_WALLS = {}


def _walled(fn, *args):
    t0 = time.monotonic()
    try:
        return fn(*args)
    finally:
        PHASE_WALLS[fn.__name__] = time.monotonic() - t0


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA GPU", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch is not importable next to "
              f"this script: {e}", file=sys.stderr)
        return 2
    paddle_tpu_torch.setup_precision()
    dev = paddle_tpu_torch.resolve_device("cuda")
    records = {}
    launches = {}
    t_start = time.monotonic()
    smi_line = _walled(phase_device, torch)
    _walled(phase_build)
    _walled(phase_kernels, torch, dev, records)
    model, engine_prompts = _walled(phase_engine, torch, dev, records,
                                    launches)
    _walled(phase_server, torch, dev, model)
    _walled(phase_engine_prefix, torch, dev, model)
    _walled(phase_engine_spill, torch, dev, model)
    _walled(phase_server_resurrect, torch, dev, model)
    _walled(phase_engine_chunked, torch, dev, model)
    _walled(phase_engine_spec, torch, dev, model, records)
    _walled(phase_server_chunked_spec, torch, dev, model)
    small = _walled(phase_engine_multi_step, torch, dev, model,
                    engine_prompts)
    _walled(phase_server_multi_step, torch, dev, small)
    _walled(phase_server_observe_swap, torch, dev, model, engine_prompts,
            smi_line)
    _walled(phase_fleet, torch, dev, model, smi_line)
    _walled(phase_fleet_autoscale, torch, dev, model, smi_line)
    _walled(phase_generate, torch, dev, model, smi_line)
    del model, small
    # the engine and the server leave reference cycles: collected here,
    # they free the model and its KV pool before the train phase reads
    # its peak memory, instead of whenever the collector next runs
    gc.collect()
    torch.cuda.empty_cache()
    _walled(phase_train, torch, dev, launches)
    _walled(phase_train_bf16, torch, dev, launches)
    _walled(phase_train_amp, torch, dev, launches)
    _walled(phase_resnet, torch, dev, launches)
    _walled(phase_resnet_train, torch, dev)
    _walled(phase_vision_zoo, torch, dev)
    _walled(phase_vision_layers, torch, dev)
    _walled(phase_vision_folder, torch, dev)
    _walled(phase_vision_ops, torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _walled(phase_bert_pretrain, torch, dev, records)
    _walled(phase_bert_classify, torch, dev)
    _walled(phase_export, torch, dev, smi_line)
    _walled(phase_seq2seq_beam, torch, dev)
    emit({"phase": "check_margins", "tightest": tightest_checks()})
    if FAILED_CHECKS:
        emit({"phase": "checks", "ok": False, "failed": FAILED_CHECKS})
        for failed in FAILED_CHECKS:
            print(f"chip_smoke: failed check: {failed[:600]}",
                  file=sys.stderr)
        print(f"chip_smoke: {len(FAILED_CHECKS)} checks failed",
              file=sys.stderr)
        return 1
    emit({"phase": "phase_walls", "seconds": PHASE_WALLS})
    emit({"phase": "wall", "seconds": time.monotonic() - t_start})
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = records[name]
        # bound_by is "bytes" or "operations"; the products' route
        # (3xtf32 or bf16) goes beside it
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bound_by"] == "bytes"
                         else "operations"),
            "bound_route": r["bound_by"], "library_ms": r["library_ms"]})
        for key in ("verify_shape", "per_shape"):
            if key in r:
                kernels[-1][key] = r[key]
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
