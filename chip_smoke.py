"""Drive the PyTorch port on one NVIDIA GPU: the REXAVM fleet, and
h2o-danube-1.8b, rwkv6-7b, qwen2-moe-a2.7b (on the int8 KV cache), the
repo's other moe and dense configs, and zamba2-1.2b, whisper-tiny and
internvl2-2b (the hybrid, encdec and vlm families) served with the VM
fleet as their measuring job; h2o-danube-1.8b trained at full width
and depth, through flash attention's backward kernel; rwkv6-7b trained at
full width (12 of its 32 layers) through rwkv6_scan's backward kernels;
and zamba2-1.2b's train step; and danube's sharded prefill, decode and
train steps on the (1, 1) device mesh.

    python3 chip_smoke.py [--nodes N]

Run from the root of a checkout on a machine with CUDA and nvcc.  Phases,
each printing its results on a line of its own:

  1. the card's name and power limit (nvidia-smi);
  2. build the five CUDA kernels (vmloop, fixmatmul, flash attention,
     rwkv6_scan, lut_sigmoid) from the sources in the checkout, one nvcc
     per source (flash attention has three: the bf16 forward on the tensor
     cores, the f32 forward on the FP32 pipes, the backward, bf16 on the
     tensor cores and f32 on the FP32 pipes; rwkv6_scan two: the forward's
     routes and the backward), all started together, and
     print each one's ptxas
     register and spill lines (rwkv6_scan's decode kernel, flash
     attention's forward instances at HD_PAD 80 and 128 and its backward's
     tensor-core kernels at HD_PAD 64, 80 and 128 on lines of their own);
  3. hold vmloop against its plain PyTorch version on the card: the
     per-opcode sweep and a batch of random node states, byte for byte on
     every field and on n_exec/bailed/bail_op, over every node and over a
     row list with per-row budgets; every claimed word must run in the
     kernel, task/rnd/FIOS must bail; the same for vmloop's counting
     instance (obs=True), its per-row retirement histograms included, and
     for its checks-elided instance (elide_checks=True) over the sweep
     programs the port's verifier admits (where it also equals the default
     instance) and over random states, which mostly do not verify;
  4. the fleet's main path: FleetVM(VMConfig(), n=4096, executor="cuda"),
     every node running a small fixed-point ANN (vecfold + dotprod +
     sigmoid), then sending its result round a ring; every 16th node also
     spawns a task and draws `rnd`, words the kernel declines and hands to
     the interpreter one at a time.  Run with service_every=1 and 8, each
     held byte for byte against executor="batched" on the card; every node
     must halt, and bail_hist must be {"task": 256, "rnd": 256} with 512
     instructions in the interpreter.  Each FleetVM.run is split into
     start, rounds and sync; (4b) three rounds split into the executor's
     own layers (schedule, each kernel launch, each hand-back, preempt)
     and routing; (4c) the same fleet with the telemetry plane on
     (ObsConfig: traced, a 1 ms virtual-clock deadline, timed rounds)
     under executor="cuda" (every kernel pass on vmloop's counting
     instance) and "batched": the counters equal bin for bin, the final
     states those of the run without obs, four spans a round in the
     validated Chrome trace, and steps/s with obs beside those without;
     (4d) the ANN ring at 256 nodes under executor="oracle" (the
     plain-Python Oracle), byte for byte against "cuda", with each one's
     wall time; a 5-replica EnsembleVM on the card with one replica's
     stack bit-flipped mid-run, which the vote must flag; (4e) the Auditor
     on the main path: (a) the same ring without the spawners under
     executor="auto" must plan ("cuda", elided), verify every node, predict
     no declined word, launch only vmloop's checks-elided instance and end
     byte for byte as executor="cuda" with the checks on, timed in turns
     (cuda, auto, auto, cuda); (b) phase 4's own ring under "auto" must plan
     ("batched", elided), end as phase 4's batched run, and predict the
     declined words phase 4's cuda bail_hist met; (4f) the Executive at
     full width: 4096 nodes of VMConfig() under ExecutiveConfig() (quantum
     32, 8 micro-slices a round) with io_mode="vector", task 0 the ring
     without spawners; before start() Executive.spawn (a deadline, so the
     verifier's WCET bound admits it) adds a prio-1 sampler to every node
     (a loop longer than a quantum, uart.write, 1 sleep), an fs.save task
     to every 16th (a CheckpointManager in a temporary directory), and to
     every 64th a second prio-1 task and a spawn whose deadline the WCET
     bound rejects.  Held byte for byte: cuda against batched (states, out
     streams, the UART stream, checkpoint ids, executive_stats), vector
     against partial under cuda (per-node scalar callbacks with the same
     effects), and executor="oracle" against cuda on a 256-node copy; at
     least 8 vmloop launches a round.  Prints start / rounds / sync ms,
     steps/s, the Executive's counters and the WCET admission's host ms,
     the host IO service's ms, round 0 by layer (schedule_prio, each
     launch, hand-back, preempt, route and warp) and the ring without the
     Executive in turns; (4g) the trace-JIT at full width: 4096 nodes of
     VMConfig() running one firmware (the ANN step with a noise draw by
     `rnd`, a word the kernel hands back, in a loop without end), one
     program group on the full-fleet path: (a) round 0 by layer (schedule,
     probe, recording, specialized steps, tail launches, hand-back,
     preempt, route and warp) and the host syncs of a specialized slice,
     then 8 rounds a run in turns, trace, cuda, trace, cuda, batched, each
     byte for byte the first, with steps/s and start / rounds / sync ms,
     trace_stats() (one group, > 90% specialized), vmloop launched only as
     the tail with per-node budgets and never its plain version, and one
     specialized slice under torch.profiler (kernels and device ms a step,
     the device's busy share); (b) the
     same fleet under executor="auto" (plan ("trace", False), ["rnd"]
     predicted, 4096 AOT branch sets, nothing built during the run, the
     Auditor's ms); (c) phase 4f's Executive fleet with that firmware as
     task 0, trace against cuda for 5 rounds (states, streams,
     executive_stats, exec_slices); (d) phase 4's ring at 64 nodes, one
     program a node, trace against cuda; (e) the serve monitor (64 nodes)
     under trace against cuda, and REXAVM(backend="cuda"|"trace") against
     the Oracle over tests/test_vm_pallas.py's host-IO programs;
  5. vmloop's time per launch, its plain version's time, and its bound,
     on the fleet (n = 4096) and on the serve monitor's 64 nodes, with the
     longest node's instructions and the ns each took; at each point the
     counting instance is timed in turns with the default one and held
     against its plain version (states and op_hist), at n = 4096 the
     checks-elided instance and the Executive's budget of 32 too, and at
     the trace tail's per-node budgets (4g's round 0) in turns with the
     default instance on the same state, and the
     serve monitor runs three steps with obs on the counting instance;
  6. fixmatmul bitwise against its plain version at danube's decode shapes
     (M = 1, 2, 4, 8, 16 on the streaming kernel, 17 and 64 on the tiled
     one), rwkv6's lm_head, the decode shapes of phases 7g, 7h and 7i at
     M = 8, ragged shapes, operands misaligned by a byte
     and extreme codes; flash attention
     against its plain version in bf16 and f32 over causal / non-causal,
     windows (one of no multiple of 64), GQA, B 2, Sq != Sk, ragged
     lengths, head_dim 16/36/64/72/80/128, head_dim 128 causal without a
     window at query groups of 1 (S 8192, qwen2-moe's prefill), 9 and 48,
     and strided views (the BSHD view, a row stride the bf16 kernel's
     16-byte copies cannot take);
     rwkv6_scan against its plain version in bf16 and f32 (chunks of 64,
     32, 16 and 1, S < 64, many chunks, a non-zero and an aliased state,
     head size 64, 36 and 16, a decay steep enough to clip, chained
     halves, one step at the decode shape, at H 3 and K 36), every call of
     two or more chunks on the two passes (state pass, output pass), of
     one step on the decode kernel (also held against its closed form and
     the one-block kernel) and of one chunk of 1 < S <= 64 on the
     one-block kernel; four decode steps in place on one B 8 x H 64 state,
     back to back, against four plain steps;
     lut_sigmoid byte for byte (INT_MIN, INT_MAX, the saturation edge,
     every LUT knot and its neighbours, 2**24 random values, 1-D and 3-D);
  7. the serve path at full width: h2o-danube-1.8b (24 layers, bf16,
     weights drawn on the card from a seed).  (a) prefill: Model.forward at
     B = 1, S = 8192 through the flash kernel (24 launches, all on the
     tensor cores), held against
     the same forward with the plain attention; (b) quantize_params, then
     ServeEngine with FleetServeMonitor(n=64, executor="cuda") as on_step,
     64 greedy tokens for 8 prompts of 128 seeded tokens: 169 fixmatmul
     launches per decode step, vmloop launched by the monitor, every node
     reporting [8] * 64; (c) a small-input reference: the SMOKE config's
     quantized engine on the card gives the CPU's tokens; (d) where a
     decode step's device time goes (torch.profiler); (e) rwkv6-7b at full
     width (32 layers, d 4096, 64 heads of 64, bf16), after danube is
     freed: prefill B 1, S 8192 (32 rwkv6_scan launches, all on the two
     passes) against the same forward through the plain chunked_wkv; the
     quantized engine with the 64-node monitor (32 rwkv6_scan and 1
     fixmatmul launches per decode step, all 6,144 on the decode kernel); the
     SMOKE config's quantized engine on the card gives the CPU's tokens; a
     decode step's profile; (f) the lutact path:
     fixed_sigmoid over int32 activations of 1024 x 1024 and 8192 x 8192;
     (g) qwen2-moe-a2.7b at full width and depth (24 layers, d 2048, 16
     heads of 128, 60 experts in 64 slots top-4 + 4 shared, bf16, seed 0)
     with kv_cache_dtype="int8": prefill B 1, S 8192 (24 flash launches on
     the HD_PAD 128 instance) against the plain attention by mean |logit
     difference| and argmax agreement (calibrated by the plain version
     with its sums reordered: in an MoE layer a reordered sum can move a
     token to another expert), with the aux loss, and flash against its
     plain version on every layer's own q, k, v; quantize_params (the
     attention projections and lm_head; the experts and the router stay
     bf16), then the engine with the 64-node monitor on the int8 cache,
     64 greedy tokens for 8 prompts of 128 (one fixmatmul launch a
     quantized leaf a step: 97); a decode step's device time by layer
     (expert products, MoE routing/dispatch/combine, attention, fixmatmul,
     the rest); the SMOKE config's quantized engine on the int8 cache on
     the card gives the CPU's tokens; (h) qwen3-moe-30b-a3b (24 of 48
     layers), starcoder2-7b and glm4-9b (full depth) and granite-34b (24
     of 88 layers) at full width, one at a time: prefill B 1, S 4096
     through flash against the plain attention as in (g) (and on every
     layer's own inputs), then 16 greedy
     tokens for 8 prompts of 32 on the quantized engine with the int8
     cache; (i) zamba2-1.2b (38 Mamba2 layers, the shared attention
     block every 6), whisper-tiny (4 + 4 layers) and internvl2-2b (24
     layers) at full width and depth, bf16, seed 0, one at a time:
     prefill through flash against the plain attention as in (h), and
     flash against its plain version on each call's own q, k, v, the
     calls counted by mask, key length and instance (zamba2: B 1, S 8192,
     6 causal calls on HD_PAD 64; whisper: B 8, 1500 stub frames, 448
     tokens, 4 non-causal calls at Sk 1500 and 4 causal ones on HD_PAD
     64; internvl2: 256 stub patch embeddings + 7936 tokens, 24 causal
     calls on HD_PAD 128); zamba2's Mamba layers' device ms in a profiled
     prefill; then 16 greedy tokens for 8 prompts of 32 on the quantized
     engine with the monitor (43 / 33 / 169 fixmatmul launches a step);
     the SMOKE config's quantized engine on the card gives the CPU's
     tokens; each of (g), (h) and (i) prints its wall time;
  8. each kernel's time per launch at the main path's shapes, its plain
     version's, one PyTorch library call's where there is one, and its
     bound; fixmatmul per decode shape (danube's, rwkv6's lm_head,
     qwen2-moe's and internvl2's lm_head), beside its tiled kernel's
     time; flash at danube's prefill shape, at qwen2-moe's (the HD_PAD
     128 instance), at zamba2's shared block and at whisper's encoder
     (B 8, Sk 1500, non-causal; both on the HD_PAD 64 instance);
     rwkv6_scan's two passes at the prefill shape in turns with its
     one-block kernel, and each pass's device time; its decode kernel at
     the decode shape in turns with the one-block kernel;
  9. training: (a) flash attention's backward kernel against its plain
     version (``ref.flash_attention_bwd_ref``, from the forward kernel's
     output and log-sum-exp, both held against
     ``ref.flash_attention_lse_ref``) in bf16 at danube's shape (B 1, H
     32/8, S 4096, hd 80, window 4096), a window shorter than S (S 8192),
     qwen2-moe's hd 128 causal, zamba2's HD_PAD 64 causal and whisper's
     non-causal encoder (B 8, S 1500), and in f32 at danube's heads (S
     2048), each timed beside the plain version, SDPA's backward through
     autograd and the bound; (b) h2o-danube-1.8b whole (24 layers, bf16,
     AdamW, remat) through ``Trainer.run_slice``: 5 steps at seq 4096 and
     global batch 4 (train_4k's 256 cut to fit one card) on the synthetic
     pipeline, per step loss, grad_norm, ms, tokens/s, peak memory and the
     flash launches (48 forward: 24 layers, twice under remat; 72
     backward: 24 calls of three kernels, 48 of them on the tensor cores);
     (c) one train step of danube at full width and 4 layers
     through the kernels against the same step from the same state with
     the plain attention (autograd through ``blocked_attention``): loss,
     grad_norm and updated leaves agree;
 10. rwkv6 and zamba2 training: (a) rwkv6_scan's backward kernels (the
     dstate pass and the gradient pass) against the plain backward
     (autograd through ``ref.rwkv6_scan_ref``, over slices of the heads)
     at rwkv6-7b's 64 heads of 64: the serve prefill's B 1 S 8192 bf16,
     the training shape B 4 S 4096 bf16, one chunk (S 64), f32 at B 1 S
     2048, a state in and a gradient of the last state out (B 2 S 1024),
     and a decay past the clip at -60, every bf16 call on the tensor-core
     kernels; each timed beside the plain version and its bound (no
     library call computes it), the bound with every f32 FLOP on the
     FP32 pipes beside it; each
     kernel's HMMA count in the library's SASS (cuobjdump), ptxas line
     and resident warps an SM; (b) the cell
     rwkv6-train-4k: rwkv6-7b at full width with 12 of its 32 layers
     (3.16 B parameters; the whole model's AdamW state passes one card),
     bf16, AdamW, remat, through ``Trainer.run_slice``: 5 steps at seq
     4096 and batch 4, per step loss, grad_norm, ms, tokens/s, peak memory
     and the launches (24 forward, all on the two passes, and 12 backward
     calls of two kernels a step); (c) one AdamW step at full width and 2
     layers through the kernels against the same step with
     ``wkv=chunked_wkv``, where the kernel step calls no plain scan; (d)
     zamba2-1.2b: one step at full width and 6 layers (the shared block
     once, on flash's HD_PAD 64 forward with lse and its backward) against
     the plain-attention step, then the whole model (38 layers) for 3
     steps at seq 4096 and the largest of batch 4, 2, 1 that fits;
 11. the sharded fleet (``FleetVM(mesh=)``): (a) phase 4's ring under
     executor="cuda" on ``make_node_mesh()`` (one shard a card) and on
     ``make_node_mesh(4, device="cuda")`` (four shards on the card, each in
     storage of its own), in turns with the meshless fleet (meshless,
     one, four, four, one, meshless), every run byte for byte phase 4's
     meshless cuda run (states, outputs, steps, kernel_stats with
     bail_hist {"task": 256, "rnd": 256}), vmloop launched once a shard
     (>= 4 a round on four shards); rounds ms and steps/s of each beside
     the meshless run's, and the router's descriptor copies and bytes a
     round; (b) partial IO at 4096 nodes on the four shards (every 64th
     node calls a FIOS word): the IO service's d2h bytes the nodes
     serviced times one node's bytes, equal to the meshless run; (c) the
     first 4094 nodes of (b)'s fleet (four shards do not divide them)
     replicated: spec (), as many launches as the meshless run; (d) phase
     4f's Executive fleet, phase 4g's firmware under "trace" and "auto"
     (two rounds each), and phase 4c's observed run on the four shards,
     each equal to its meshless run; (e)
     FleetServeMonitor(n=64) on the four shards over a fixed ServeStats
     sequence, equal to the meshless monitor.  No speed is claimed: the
     times are the card's own, beside its name and power limit;
 12. the model-side sharding: an NCCL process group of one rank (its
     store a file under build/), the (1, 1) DeviceMesh from
     ``launch.mesh.make_mesh``, and h2o-danube-1.8b at full width and
     depth through ``launch.steps``: (a) ``build_prefill`` at B 1 S 8192;
     (b) ``build_decode`` with ``quantized_serve`` (int8 weights through
     fixmatmul) for 16 steps of B 8 against a 4096-token cache; (c)
     ``build_train_step``, 2 AdamW steps at seq 4096 batch 4.  Each equals
     the unsharded port path on the same card to the bit: the logits, the
     cache and the loss, then the updated parameters.  The sharded runs
     must launch flash's forward (on the tensor cores) 24 times a
     prefill, fixmatmul 169 times a decode step, and flash's forward 48
     times and its backward 24 calls a train step; one line gives each
     step's ms, tokens/s and peak memory.  The group is destroyed however
     the phase ends;
 13. the MoE family, whisper and internvl2 train (run after phase 10):
     (a) qwen2-moe-a2.7b at full width and 2 layers, one AdamW step at B 1
     S 4096 through the kernels against the plain-attention step, the
     kernel step's expert ids replayed in the plain step (its weights its
     own probabilities at those ids), after a line that counts the
     assignments the plain step's own top-k would have routed apart;
     loss, aux, grad_norm and the router, expert, shared-expert,
     attention, embedding and lm_head leaves held as in 9 (c); (b) the
     cell moe-train-4k: qwen2-moe at full width with 6 of its 24 layers
     (4.05 B parameters), 5 steps at seq 4096 and the largest of batch
     4, 2, 1 that fits, each step's line with its aux loss, the share of
     assignments dropped by capacity and the largest expert's load over
     the mean; then qwen3-moe-30b-a3b the same way at 6 of its 48 layers,
     3 steps; (c) whisper-tiny whole: a kernel step against the plain
     step at B 1, then 5 steps of 448 text tokens over 1500 stub frames
     at the largest of batch 64, 32, 8 that fits (each step 8 flash
     calls: 4 non-causal in the encoder, 4 causal in the decoder); (d)
     internvl2-2b: a kernel step at 4 layers against the plain step
     (``vision_proj`` among the leaves), then the whole model, 5 steps of
     256 stub patches + 3840 text tokens at the largest of batch 4, 2, 1
     that fits; every step's flash launches counted (each layer's forward
     twice under remat, its backward three kernels, all bf16 on the
     tensor cores); then flash's forward and backward at these training
     shapes beside SDPA's forward and backward.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 33.5e12       # H100 SXM non-tensor INT32 rate (data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor-core rate (data sheet)
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core rate (data sheet)
N_NODES = 4096
ITERS = 20                      # ANN iterations per node
ARCH = "h2o-danube-1.8b"
PREFILL_LEN = 8192              # crosses danube's 4096 window
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS, MONITOR_NODES = 8, 128, 64, 64
SEED = 0
L2_BYTES = 50e6                 # H100 L2; timed weights are rotated past it
FP32_FLOPS = 67e12              # H100 SXM f32 rate outside the tensor cores (data sheet)
SFU_PER_S = FP32_FLOPS / 16     # special-function ops (exp): 16 per SM per clock against
                                # 128 f32 FMA lanes (NVIDIA throughput table, compute capability 9.0)
RWKV_ARCH = "rwkv6-7b"
MOE_ARCH = "qwen2-moe-a2.7b"    # phase 7g, full width and depth, int8 KV cache
# phase 7h: the other configs at full width, each with the layers it keeps
# (None: all); the cuts keep each model's weights, two prefills' logits and
# its int8 copies on the 80 GB card
OTHER_ARCHS = (("qwen3-moe-30b-a3b", 24), ("starcoder2-7b", None), ("glm4-9b", None),
               ("granite-34b", 24))
SHORT_LEN, SHORT_PROMPT, SHORT_NEW = 4096, 32, 16   # phase 7h (and 7i): prefill, prompts, new tokens
# phase 7i: the hybrid, encdec and vlm families at full width and depth,
# with the fixmatmul launches a decode step each must give at M 8
FAMILY_ARCHS = ("zamba2-1.2b", "whisper-tiny", "internvl2-2b")
FAMILY_FIX_PER_STEP = {"zamba2-1.2b": 43, "whisper-tiny": 33, "internvl2-2b": 169}
WHISPER_BATCH, WHISPER_TEXT = 8, 448    # phase 7i: whisper's prefill batch and text context
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 4, 5   # phase 9 (b): train_4k, its batch cut to 4
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH = 4, 1       # phase 9 (c): kernel step vs plain step
FLASH_BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # max |dq, dk, dv diff| / max |plain|
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL = 1e-2, 5e-2       # phase 9 (c): relative, bf16 over 4 layers
TRAIN_LEAF_CLOSE = 0.95        # phase 9 (c): share of a leaf within its bf16 rounding
RWKV_BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}   # phase 10 (a): max |grad diff| / max |plain|
PLAIN_ROWS = 16 * 8192          # phase 10 (a): batch x heads x seq of one slice of the plain backward
RWKV_TRAIN_LAYERS = 12          # phase 10 (b): rwkv6-7b's 32 layers cut to fit one card
RWKV_CHECK_LAYERS, RWKV_CHECK_STEPS = 2, 3   # phase 10 (c): kernel steps vs plain-scan steps
ZAMBA_ARCH = "zamba2-1.2b"      # phase 10 (d)
ZAMBA_CHECK_LAYERS = 6          # the shared attention block runs once
ZAMBA_TRAIN_STEPS, ZAMBA_BATCHES = 3, (4, 2, 1)     # the whole model, the largest batch that fits
MOE_CHECK_LAYERS = 2            # phase 13 (a): qwen2-moe's kernel step vs plain step, routing replayed
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 6, 5   # phase 13 (b): qwen2-moe's 24 layers cut to fit one card
QWEN3_TRAIN = ("qwen3-moe-30b-a3b", 6, 3, "qwen3-moe-train-4k")   # (b): arch, layers, steps, cell
TRAIN_BATCHES = (4, 2, 1)       # phase 13 (b), (d): the largest that fits
WHISPER_ARCH, WHISPER_TRAIN_STEPS, WHISPER_BATCHES = "whisper-tiny", 5, (64, 32, 8)  # 13 (c)
VLM_ARCH, VLM_CHECK_LAYERS, VLM_TRAIN_STEPS = "internvl2-2b", 4, 5                    # 13 (d)
RWKV_TOL = {"bfloat16": 1e-2, "float32": 1e-4}    # out: max abs err / max(1, max |plain|)
RWKV_STATE_TOL = 1e-4           # the state (f32 in both), the same measure
LUT_SIZES = (1024, 8192)        # fixed_sigmoid inputs: bench_kernels.py's size, one past L2
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # max abs err vs the plain version
PREFILL_REL_TOL = 5e-2          # max |logit diff| / max |logit|, bf16 over 24 layers
ALT_MEAN_TOL = 1.5              # rwkv6 prefill: mean |logit diff| against the plain version
ALT_AGREE_TOL = 0.02            # reordered, and the argmax agreement (see prefill)
SPIN_CYCLES = 100_000_000       # ~50 ms of spinning at the H100's clock
SMOKE_TOL = 2e-2                # max |logit diff|, card vs CPU, SMOKE quantized decode
OBS_DEADLINE_MS = 1             # phase 4c: a round of more than 100 instructions misses it
ORACLE_NODES = 256              # phase 4d: the ANN ring under executor="oracle"
ENSEMBLE = 5                    # phase 4d: replicas, one of them bit-flipped
SAMPLER = "0 50 0 do 1+ loop uart.write 1 sleep"   # phase 4f: 108 instructions at most
SECOND = "0 40 0 do 1+ loop uart.write"            # phase 4f: every 64th node, prio 1
SAMPLER_DEADLINE_MS = 50        # phase 4f: feasible (the WCET bound is 2 virtual ms)
REJECTED_DEADLINE_MS = 1        # phase 4f: infeasible
# phase 4g: one firmware on every node, the sensor ANN step forever with a
# noise draw by `rnd` (a word the kernel hands back) in every iteration
TRACE_PROGRAM = ("array x { 10 20 30 40 } array w { 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 } "
                 "array y { 0 0 0 0 } var acc "
                 ": sense begin x w y 0 vecfold x y dotprod 256 rnd + acc +! again ; sense")
TRACE_ROUNDS = 8                # phase 4g (a), (b): rounds a run
TRACE_EXEC_ROUNDS = 5           # phase 4g (c)
TRACE_RING_NODES = 64           # phase 4g (d): phase 4's ring, one program a node
SHARDS = 4                      # phase 11: shards of the one-card node mesh
PARTIAL_IO_EVERY = 64           # phase 11 (b): every 64th node calls a FIOS word
REPLICATED_NODES = 4094         # phase 11 (c): a ring SHARDS does not divide
SHARD_TRACE_ROUNDS = 2          # phase 11 (d): rounds of 4g's firmware under trace and auto
MONITOR_STEPS = 5               # phase 11 (e): ServeStats steps of the monitors
MESH_PREFILL_LEN = 8192         # phase 12 (a): B 1
MESH_DECODE = (8, 4096, 16)     # phase 12 (b): batch, cache length, steps
MESH_TRAIN = (4, 4096, 2)       # phase 12 (c): batch, seq, steps
HOST_IO = (("0 30 0 do 1+ loop out halt", False), ("seven 1+ halt", True),
           ("var flag : w 1 flag ! end ; 0 0 $ w task drop 100 1 flag await . flag @ . halt",
            False))             # phase 4g (e): tests/test_vm_pallas.py's host-IO programs


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ann_program(i: int, n: int, spawners: bool = True) -> str:
    """Node i of the n-node ANN ring; with ``spawners`` every 16th node also
    spawns a task and draws ``rnd`` (words the kernel declines)."""
    extra = ""
    if spawners and i % 16 == 0:
        extra = ": worker 5 0 do i acc +! loop ; 0 0 $ worker task drop 100 rnd acc +! "
    return (
        "array x { 10 20 30 40 } "
        "array w { 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 } "
        "array y { 0 0 0 0 } var acc "
        f"{extra}"
        f"0 begin 1+ x w y 0 vecfold x y dotprod acc +! dup {ITERS} >= until drop "
        f"acc @ 4000 mod 2000 - sigmoid {(i + 1) % n} send "
        "receive swap drop acc ! acc @ . halt"
    )


def differing(A, B, pairs, limit: int = 6) -> list:
    """(word, program, field) of the first nodes where A and B differ."""
    out = []
    for f in A._fields:
        a, b = getattr(A, f), getattr(B, f)
        rows = (a != b).reshape(a.shape[0], -1).any(dim=1).nonzero().flatten().tolist()
        out += [(*pairs[i], f) for i in rows[:limit]]
    return out[:limit]


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=N_NODES, help="fleet size of phase 4")
    args = ap.parse_args()
    n_nodes = args.nodes

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import importlib

        from repro_torch.config import VMConfig
        from repro_torch.core.vm import FleetVM, REXAVM, vmstate as vms
        from repro_torch.kernels.nvcc import BuildError
        from repro_torch.kernels.vmloop import check, vmloop as kmod
        from repro_torch.kernels.vmloop.ref import SUPPORTED_WORDS, core_of, vmloop_ref
        fix_mod = importlib.import_module("repro_torch.kernels.fixmatmul.fixmatmul")
        flash_mod = importlib.import_module("repro_torch.kernels.flashattn.flashattn")
        rwkv_mod = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")
        lut_mod = importlib.import_module("repro_torch.kernels.lutact.lutact")
    except ImportError as e:
        fail(f"the repository's src/repro_torch is not beside this script ({e})")
    dev = torch.device("cuda")
    # The plain versions' float32 products run in full f32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # 2. build: one nvcc per kernel, all started together
    t0 = time.perf_counter()
    libs = (kmod.LIBRARY, fix_mod.LIBRARY, flash_mod.LIBRARY, flash_mod.TC_LIBRARY,
            flash_mod.BWD_LIBRARY, rwkv_mod.LIBRARY, rwkv_mod.BWD_LIBRARY, lut_mod.LIBRARY)
    with ThreadPoolExecutor(len(libs)) as pool:
        for lib, fut in [(lib, pool.submit(lib.build)) for lib in libs]:
            try:
                fut.result()
            except BuildError as e:
                fail(f"{lib.name} did not build: {e}")
    for lib in libs:
        lib.load()
        print(f"build: {lib.name} {lib.seconds:.2f} s nvcc", flush=True)
        print(f"ptxas {lib.name}: " + " | ".join(lib.ptxas_lines()), flush=True)
    print("ptxas rwkv6_decode_kernel: " + " | ".join(
        ptxas_of(rwkv_mod.LIBRARY, "rwkv6_decode_kernel") or ["not in the report"]), flush=True)
    for hd_pad in (80, 128):
        for lse, path in ((0, "serve"), (1, "training, with lse")):
            print(f"ptxas flash_tc_kernel<{hd_pad}> ({path}): " + " | ".join(
                ptxas_of(flash_mod.TC_LIBRARY, f"flash_tc_kernelILi{hd_pad}ELb{lse}E")[1:]
                or ["not in the report"]), flush=True)
    for p in (64, 80, 128):
        for k in ("dkdv_tc", "dq_tc"):
            print(f"ptxas flashattn_bwd {k}_kernel<{p}> (bf16, tensor cores): " + " | ".join(
                ptxas_of(flash_mod.BWD_LIBRARY, f"{k}_kernelILi{p}E")[1:]
                or ["not in the report"]), flush=True)
    print("ptxas flashattn_bwd dkdv/dq f32 <80>, <128>: " + " | ".join(
        (ptxas_of(flash_mod.BWD_LIBRARY, f"{k}_kernelILi{p}E") or ["none"])[-1]
        for p in (80, 128) for k in ("dkdv", "dq")), flush=True)
    print(f"build: all {len(libs)} sources {time.perf_counter() - t0:.2f} s with loading",
          flush=True)
    # 3. kernel vs plain version on the card
    max_err = 0
    for cfg in (VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4), VMConfig()):
        pairs, S = check.sweep_states(cfg, dev)
        P = vms.clone(S)
        _, n_k, b_k, o_k = kmod.vmloop_call(core_of(S), cfg.steps_per_slice, cfg)
        _, n_p, b_p, o_p = vmloop_ref(P, cfg.steps_per_slice, cfg)
        torch.cuda.synchronize()
        err, bad = check.max_abs_diff(S, P)
        for name, a, b in (("n_exec", n_k, n_p), ("bailed", b_k, b_p), ("bail_op", o_k, o_p)):
            if not torch.equal(a, b):
                bad.append(name)
                err = max(err, int((a.long() - b.long()).abs().max()))
        if bad:
            fail(f"sweep (cs_size={cfg.cs_size}): kernel != plain on {bad}, max abs err {err}; "
                 f"programs: {differing(S, P, pairs)}")
        max_err = max(max_err, err)
        n_k, b_k = n_k.cpu().tolist(), b_k.cpu().tolist()
        ran = {w for (w, _), n in zip(pairs, n_k) if n > 0}
        missing = set(SUPPORTED_WORDS) - ran
        if missing:
            fail(f"claimed words the kernel did not execute: {sorted(missing)}")
        for (w, p), b in zip(pairs, b_k):
            if w in ("task", "rnd", "fios/trap") and not b:
                fail(f"kernel did not bail on {w!r} ({p})")
        R = check.random_states(cfg, 1024, seed=cfg.cs_size, device=dev)
        Rp = vms.clone(R)
        _, n_k, b_k, o_k = kmod.vmloop_call(core_of(R), 64, cfg)
        _, n_p, b_p, o_p = vmloop_ref(Rp, 64, cfg)
        torch.cuda.synchronize()
        err, bad = check.max_abs_diff(R, Rp)
        if bad or not (torch.equal(n_k, n_p) and torch.equal(b_k, b_p) and torch.equal(o_k, o_p)):
            fail(f"random states (cs_size={cfg.cs_size}): kernel != plain on {bad}, max abs err {err}")
        print(f"check cs_size={cfg.cs_size}: sweep {len(pairs)} programs, random 1024 nodes "
              f"({int(n_k.sum())} instructions, {int(b_k.sum())} bails): byte-identical", flush=True)
        check_rows_budget(torch, kmod, check, cfg, dev)
        check_counting(torch, kmod, check, cfg, dev)
        check_elided(torch, kmod, check, cfg, dev)

    # 4. the main path: the full-size fleet
    cfg = VMConfig()
    t0 = time.perf_counter()
    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n_nodes)]
    for i, vm in enumerate(nodes):
        vm.launch(vm.load(ann_program(i, n_nodes)))
    init = [vms.clone(vm.state) for vm in nodes]
    state_mb = vms.state_nbytes(init[0]) * n_nodes / 1e6
    print(f"fleet: {n_nodes} nodes, {state_mb:.1f} MB of state, set up in {time.perf_counter() - t0:.1f} s", flush=True)

    def run(executor: str, service_every: int, obs=None, ring=None):
        """One FleetVM.run of phase 4's ring (or ``ring``, (nodes, initial
        states)) from its initial states, split into start / rounds / sync
        (and, under "auto", the Auditor's share of start)."""
        ring_nodes, ring_init = ring or (nodes, init)
        for vm, st in zip(ring_nodes, ring_init):
            vm.state = vms.clone(st)
            vm.out_stream.clear()
        fleet = FleetVM(nodes=ring_nodes, executor=executor, device=dev, obs=obs)
        split = {}
        names = ("start", "sync") + (("_resolve_auto",) if executor == "auto" else ())
        res, dt, final = timed_run(torch, fleet, split, names, service_every=service_every)
        return fleet, res, dt, final, split

    kmod.vmloop_call.launches = 0
    results = {}
    for every in (1, 8):
        for executor in ("cuda", "batched"):
            results[executor, every] = run(executor, every)
    launches = kmod.vmloop_call.launches
    spawners = len(range(0, n_nodes, 16))         # nodes that meet task and rnd
    for every in (1, 8):
        fc, rc, dtc, Sc, split_c = results["cuda", every]
        fb, rb, dtb, Sb, split_b = results["batched", every]
        if rc.statuses != ["halt"] * n_nodes:
            fail(f"service_every={every}: not every node halted: "
                 f"{sorted(set(rc.statuses))}")
        err, bad = check.max_abs_diff(Sc, Sb)
        if bad or rc.outputs != rb.outputs or rc.rounds != rb.rounds:
            fail(f"service_every={every}: cuda != batched on {bad} (max abs err {err})")
        steps = int(rc.steps.sum())
        ks = fc.kernel_stats()
        if (ks["bail_hist"] != {"task": spawners, "rnd": spawners}
                or ks["fallback_steps"] != 2 * spawners
                or ks["kernel_steps"] + ks["fallback_steps"] != steps):
            fail(f"service_every={every}: bail_hist {ks['bail_hist']}, kernel "
                 f"{ks['kernel_steps']} / interpreter {ks['fallback_steps']} steps of {steps}: "
                 f"each of {spawners} nodes must hand back task and rnd once")
        print(json.dumps({
            "phase": "fleet", "service_every": every, "nodes": n_nodes, "rounds": rc.rounds,
            "steps": steps, "steps_per_s": steps / dtc, "rounds_per_s": rc.rounds / dtc,
            "msgs_per_s": n_nodes / dtc, "ms_per_round": 1e3 * dtc / rc.rounds,
            "kernel_steps": ks["kernel_steps"], "tail_steps": ks["fallback_steps"],
            "bail_hist": ks["bail_hist"], "bailed_node_rounds": ks["bailed_node_rounds"],
            "batched_steps_per_s": steps / dtb, "batched_ms_per_round": 1e3 * dtb / rb.rounds,
            "split_ms": split_c, "batched_split_ms": split_b,
            "identical_to_batched": True,
        }), flush=True)
    if launches <= 0:
        fail("the fleet's main path launched the vmloop kernel no time")
    print(f"main path: vmloop launched {launches} times over 4 fleet runs "
          f"(2 on executor=cuda)", flush=True)

    # 4b. where a round's time goes: the executor's own layers, each closed
    # by a synchronize (host clock), on a fresh fleet
    for vm, st in zip(nodes, init):
        vm.state = vms.clone(st)
    fleet = FleetVM(nodes=nodes, executor="cuda", device=dev)
    fleet.start()
    S, kern = fleet._S, fleet.kernels
    for rnd in range(3):
        marks = []

        def mark(layer):
            torch.cuda.synchronize()
            marks.append((layer, time.perf_counter()))

        mark("start")
        steps0 = int(S.steps.sum())
        S, n_exec, _, _ = kern.round_aux(S, cfg.steps_per_slice, mark)
        mark("route")
        ms: dict = {}
        for (_, a), (layer, b) in zip(marks, marks[1:]):
            ms[layer] = ms.get(layer, 0.0) + 1e3 * (b - a)
        passes = sum(layer == "tail" for layer, _ in marks)
        print(json.dumps({
            "phase": "breakdown", "round": rnd, "schedule_ms": ms["schedule"],
            "kernel_ms": ms["kernel"], "kernel_launches": passes + 1, "tail_ms": ms.get("tail", 0.0),
            "passes": passes, "tail_steps": int(S.steps.sum()) - steps0 - int(n_exec.sum()),
            "preempt_ms": ms["preempt"], "route_warp_ms": ms["route"],
            "round_ms": 1e3 * (marks[-1][1] - marks[0][1]),
        }), flush=True)

    # 4c. the telemetry plane on the main path: the same fleet, counted,
    # traced and timed, under cuda (the kernel's counting instance) and
    # batched; the counters equal and the states those of phase 4.  Each
    # executor runs without obs, with, with, without (in turns, so that the
    # first run's warm-up falls on neither side alone).
    from repro_torch.obs import ObsConfig, validate_chrome_trace

    obs_cfg = ObsConfig(trace=True, deadline_ms=OBS_DEADLINE_MS, time_rounds=True)
    steps_off = int(results["cuda", 1][1].steps.sum())
    kmod.vmloop_call.launches = kmod.vmloop_call.obs_launches = 0
    turns: dict = {}
    metrics = {}
    for executor in ("cuda", "batched"):
        for obs in (None, obs_cfg, obs_cfg, None):
            fleet_o, res_o, dt_o, S_o, split_o = run(executor, 1, obs=obs)
            err, bad = check.max_abs_diff(S_o, results["cuda", 1][3])
            if bad or res_o.outputs != results["cuda", 1][1].outputs:
                fail(f"obs={obs is not None}: {executor} final states differ from phase 4's on {bad} "
                     f"(max abs err {err})")
            turns.setdefault((executor, obs is not None), []).append((dt_o, split_o))
            if obs is None:
                continue
            m = fleet_o.metrics().as_dict()
            spans = validate_chrome_trace(fleet_o.export_trace())
            if spans != 4 * m["counters"]["rounds_observed"] or m["counters"]["instructions"] != steps_off:
                fail(f"obs: {executor} traced {spans} spans over {m['counters']['rounds_observed']} "
                     f"rounds, binned {m['counters']['instructions']} of {steps_off} instructions")
            if executor in metrics and metrics[executor]["counters"] != m["counters"]:
                fail(f"obs: {executor}'s two observed runs counted differently")
            metrics[executor] = m
            if executor == "cuda":
                ks = fleet_o.kernel_stats()
                if (m["counters"]["deopts"] != ks["bailed_node_rounds"]
                        or ks["bail_hist"] != {"task": spawners, "rnd": spawners}):
                    fail(f"obs: deopts {m['counters']['deopts']}, kernel_stats {ks}")
            del fleet_o, S_o
    obs_launches, all_launches = kmod.vmloop_call.obs_launches, kmod.vmloop_call.launches
    if obs_launches <= 0 or obs_launches >= all_launches:
        fail(f"phase 4c launched the counting instance {obs_launches} of {all_launches} times")
    mc, mb = metrics["cuda"]["counters"], metrics["batched"]["counters"]
    for key in ("op_retired", "instructions", "mbox_high", "mbox_drops", "io_susp",
                "deadline_miss", "rounds_observed"):
        if mc[key] != mb[key]:
            fail(f"obs: cuda != batched on {key}")

    def mean_rate(executor, obs):
        return sum(steps_off / dt for dt, _ in turns[executor, obs]) / len(turns[executor, obs])

    def mean_rounds_ms(executor, obs):
        return sum(sp["rounds_ms"] for _, sp in turns[executor, obs]) / len(turns[executor, obs])

    top = sorted(mc["op_retired"].items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "phase": "obs", "nodes": n_nodes, "rounds": mc["rounds_observed"],
        "instructions": mc["instructions"], "top_bins": dict(top),
        "deadline_ms": OBS_DEADLINE_MS, "deadline_miss_total": mc["deadline_miss_total"],
        "mbox_high": mc["mbox_high"], "io_susp": mc["io_susp"], "deopts": mc["deopts"],
        "spans": spans, "counting_launches": obs_launches,
        **{f"{ex}_steps_per_s_{'obs' if o else 'no_obs'}": mean_rate(ex, o)
           for ex in ("cuda", "batched") for o in (True, False)},
        **{f"{ex}_rounds_ms_{'obs' if o else 'no_obs'}": mean_rounds_ms(ex, o)
           for ex in ("cuda", "batched") for o in (True, False)},
        "turns_s": {f"{ex}_{'obs' if o else 'no_obs'}": [dt for dt, _ in v] for (ex, o), v in turns.items()},
        "round_latency_ms": {k: metrics["cuda"]["latency"][k] for k in ("mean_ms", "p50_ms", "p99_ms", "max_ms")},
        "identical_to_batched_and_obs_off": True,
    }), flush=True)
    del turns, metrics

    # 4d. the Oracle as a fleet executor (byte-exact with cuda on a 256-node
    # ring), and a voting ensemble on the card
    oracle_ring(torch, dev, check, VMConfig, REXAVM, FleetVM, vms)
    ensemble_vote(torch, dev, check, cfg, REXAVM, vms)

    # 4e. the Auditor on the main path: (a) the ring without the spawners
    # under executor="auto" on vmloop's checks-elided instance, against the
    # checked cuda run, in turns; (b) phase 4's ring under "auto"
    elided_launches = auditor_ring(kmod, check, cfg, dev, n_nodes, run, REXAVM, vms)
    auditor_spawners(check, n_nodes, run, results)

    # 4f. the Executive at full width: preemptive micro-slices over vmloop,
    # the vectorized syscall plane and WCET admission
    exec_launches, exec_ring = executive_phase(torch, kmod, check, cfg, dev, n_nodes, run)

    # 4g. the trace-JIT at full width: one firmware on every node, against
    # cuda and batched, under auto, under the Executive; phase 4's ring at
    # 64 nodes; the serve monitor and the single-node backends
    trace_launches, tail, firmware_ring = trace_phase(torch, kmod, check, cfg, dev, n_nodes)
    trace_executive(torch, check, cfg, dev, n_nodes)
    trace_ring(check, cfg, dev, run, REXAVM, vms)
    trace_monitor_and_nodes(torch, check, dev, REXAVM, vms)

    # 5. time per launch at n=4096, beside the plain version and the bound;
    # then at the serve monitor's 64 nodes, which launch it once a round.
    # Each point times the default instance and the counting one in turns.
    fleet_t, fleet_obs, fleet_elided, fleet_q = time_vmloop(torch, kmod, nodes, init, cfg, dev,
                                                            elided=True, quantum=True)
    fleet_obs["launches"] = obs_launches
    fleet_elided["launches"] = elided_launches
    fleet_q["launches"] = exec_launches
    fleet_tail = time_trace_tail(torch, kmod, check, tail, cfg)
    fleet_tail["launches"] = trace_launches
    from repro_torch.serve import FleetServeMonitor, ServeStats

    mon = FleetServeMonitor(n=MONITOR_NODES, executor="cuda", device=dev)
    for node, frame in zip(mon.fleet.nodes, mon._frames):     # as one engine step does
        node.dios_write("stats", [PROMPT_LEN + 1, SERVE_BATCH * PROMPT_LEN, SERVE_BATCH])
        node.launch(frame)
    mon_t, mon_obs = time_vmloop(torch, kmod, mon.fleet.nodes,
                                 [vm.state for vm in mon.fleet.nodes], cfg, dev)
    mon_obs["launches"] = monitor_obs(torch, kmod, dev, FleetServeMonitor, ServeStats, ObsConfig)
    records = [{
        "name": "vmloop", "route": "cuda",
        "source": "src/repro_torch/kernels/vmloop/csrc/vmloop.cu",
        "replaces": "src/repro/kernels/vmloop/vmloop.py:64",
        "launches": launches + elided_launches + exec_launches + trace_launches,
        "max_abs_err": max_err,
        **{k: fleet_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "per_shape": {
            f"n{n_nodes}": fleet_t, f"n{MONITOR_NODES}_monitor": mon_t,
            f"n{n_nodes}_obs": fleet_obs, f"n{MONITOR_NODES}_obs": mon_obs,
            f"n{n_nodes}_elided": fleet_elided, f"n{n_nodes}_budget32": fleet_q,
            f"n{n_nodes}_trace_tail": fleet_tail},
    }]
    phase4 = results["cuda", 1]           # phase 11 holds its sharded runs to it
    del results, S, fleet, mon
    torch.cuda.empty_cache()

    # 6. the other kernels against their plain versions
    fix_err = check_fixmatmul(torch, fix_mod, dev)
    flash_err = check_flash(torch, flash_mod, dev)
    rwkv_err = check_rwkv6_scan(torch, rwkv_mod, dev)
    check_lut_sigmoid(torch, lut_mod, dev)

    # 7. the serve paths at full width, then the lutact path; (g) qwen2-moe
    # on the int8 KV cache, (h) the other four configs of the moe and dense
    # families, (i) the hybrid, encdec and vlm families
    launches_fix, launches_flash = serve_danube(torch, dev, fix_mod, flash_mod, kmod)
    torch.cuda.empty_cache()
    launches_rwkv, launches_fix_rwkv = serve_rwkv6(torch, dev, fix_mod, rwkv_mod, kmod)
    torch.cuda.empty_cache()
    launches_lut = lutact_path(torch, dev, lut_mod)
    launches_fix_moe, launches_flash_moe = serve_moe(torch, dev, fix_mod, flash_mod, kmod)
    torch.cuda.empty_cache()
    launches_fix_other, launches_flash_other = serve_others(torch, dev, fix_mod, flash_mod, kmod)
    torch.cuda.empty_cache()
    launches_fix_fam, launches_flash_fam = serve_families(torch, dev, fix_mod, flash_mod, kmod)
    torch.cuda.empty_cache()

    # 8. time per launch at the main path's shapes
    records.append(dict(time_fixmatmul(torch, fix_mod, dev), max_abs_err=fix_err,
                        launches=launches_fix + launches_fix_rwkv + launches_fix_moe
                        + launches_fix_other + launches_fix_fam))
    records.append(dict(time_flash(torch, flash_mod, dev), max_abs_err=flash_err,
                        launches=launches_flash + launches_flash_moe + launches_flash_other
                        + launches_flash_fam))
    records.append(dict(time_rwkv6_scan(torch, rwkv_mod, dev, launches_rwkv),
                        launches=sum(launches_rwkv.values()), max_abs_err=rwkv_err))
    records.append(dict(time_lut_sigmoid(torch, lut_mod, dev), launches=launches_lut,
                        max_abs_err=0))
    torch.cuda.empty_cache()

    # 9. training: the backward kernel against its plain version, danube's
    # train steps at full width and depth, and a kernel step against a
    # plain-attention step
    bwd_record = check_flash_bwd(torch, flash_mod, dev)
    torch.cuda.empty_cache()
    launches_train_fwd, launches_train_bwd = train_danube(torch, dev, flash_mod)
    torch.cuda.empty_cache()
    train_kernel_vs_plain(torch, dev, flash_mod)
    torch.cuda.empty_cache()

    # 10. rwkv6 and zamba2 training: rwkv6_scan's backward kernels against
    # their plain version, rwkv6-7b's train steps at full width, a kernel
    # step against a plain-scan step, and zamba2's train step
    rwkv_bwd_record = check_rwkv6_bwd(torch, rwkv_mod, dev)
    torch.cuda.empty_cache()
    launches_rwkv_train, launches_rwkv_bwd = train_rwkv6(torch, dev, rwkv_mod)
    torch.cuda.empty_cache()
    rwkv6_kernel_vs_plain(torch, dev, rwkv_mod)
    torch.cuda.empty_cache()
    launches_zamba_fwd, launches_zamba_bwd = train_zamba2(torch, dev, flash_mod)
    torch.cuda.empty_cache()

    # 13. the MoE family, whisper and internvl2 train: qwen2-moe's kernel
    # step against its plain step with the routing replayed, the cells
    # moe-train-4k, whisper-train and internvl2-train-4k, and flash at
    # their shapes beside SDPA
    launches_fam_fwd, launches_fam_bwd = families_train_phase(torch, dev, flash_mod)
    torch.cuda.empty_cache()

    # 11. the sharded fleet: phase 4's ring on a node mesh of one shard a
    # card and of four shards on the card, partial IO, a replicated fleet,
    # the Executive, trace, auto, obs and the serve monitor on the mesh
    launches_sharded = sharded_phase(torch, kmod, check, cfg, n_nodes, (nodes, init), phase4,
                                     exec_ring, firmware_ring)
    del nodes, init, phase4, exec_ring, firmware_ring

    # 12. the model-side sharding on the (1, 1) mesh: danube's sharded
    # prefill, quantized decode and train step against the unsharded path
    mesh_fix, mesh_fwd, mesh_bwd = model_sharded_phase(torch, dev, fix_mod, flash_mod)
    torch.cuda.empty_cache()
    by_name = {r["name"]: r for r in records}
    by_name["fixmatmul"]["launches"] += mesh_fix
    launches_train_fwd += mesh_fwd
    launches_train_bwd += mesh_bwd
    by_name["vmloop"]["launches"] += launches_sharded
    by_name["flash_attention"]["launches"] += (launches_train_fwd + launches_zamba_fwd
                                               + launches_fam_fwd)
    by_name["rwkv6_scan"]["launches"] += launches_rwkv_train
    records.append(dict(bwd_record, launches=launches_train_bwd + launches_zamba_bwd
                        + launches_fam_bwd))
    records.append(dict(rwkv_bwd_record, launches=launches_rwkv_bwd))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phases 6-8: fixmatmul, flash attention and the danube serve path
# ---------------------------------------------------------------------------

def ptxas_of(lib, kernel: str) -> list:
    """The ptxas report of each instance of ``kernel`` in ``lib``'s last
    compile: its instance (f32 or bf16), frame and spill line, and
    register line."""
    lines, out = lib.ptxas_lines(), []
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and kernel in ln:
            out += ["bf16" if "bfloat16" in ln else "f32"] + [
                x for x in lines[i + 1:i + 3] if "registers" in x or "stack frame" in x]
    return out


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean ms per call of ``fn(i)`` over ``reps`` calls after ``warmup``,
    by CUDA events around the whole run.  A spin kernel ahead of the first
    event holds the card while the host queues the calls, so a call whose
    host side is slower than its kernel is timed on the device, not at the
    rate Python can launch it."""
    for i in range(warmup):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(reps):
        fn(warmup + i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(torch, fn):
    """(fn(), ms) by the host clock, the device synchronized on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def synchronized(torch, fn, into: dict, key: str):
    """``fn`` timed by the host clock with the device synchronized on both
    sides; each call's ms lands in ``into[key]``."""
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into[key] = 1e3 * (time.perf_counter() - t)
        return out
    return call


def timed_run(torch, fleet, split: dict, names=("start", "sync"), max_rounds: int = 200, **kw):
    """``fleet.run(max_rounds, **kw)`` with each of ``names`` (start and
    sync at least) timed on the card into ``split`` and the rest of the run
    as ``rounds_ms``; returns (result, seconds, final stacked state)."""
    from repro_torch.core.vm import vmstate as vms

    for name in names:
        setattr(fleet, name, synchronized(torch, getattr(fleet, name), split,
                                          name.strip("_") + "_ms"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fleet.run(max_rounds=max_rounds, **kw)
    dt = time.perf_counter() - t
    split["rounds_ms"] = 1e3 * dt - split["start_ms"] - split["sync_ms"]
    return res, dt, vms.stack_states([vm.state for vm in fleet.nodes])


def check_rows_budget(torch, kmod, check, cfg, dev) -> None:
    """The kernel over a row list (every third node of 1024 random ones,
    shuffled) with per-row budgets, byte for byte against the plain
    version."""
    from repro_torch.core.vm import vmstate as vms
    from repro_torch.kernels.vmloop.ref import core_of

    R = check.random_states(cfg, 1024, seed=cfg.cs_size + 1, device=dev)
    Rp = vms.clone(R)
    g = torch.Generator().manual_seed(cfg.cs_size)
    rows = torch.arange(0, 1024, 3)[torch.randperm(342, generator=g)].to(torch.int32).to(dev)
    budget = torch.randint(0, 70, (342,), generator=g).to(torch.int32).to(dev)
    out_k = kmod.vmloop_call(core_of(R), 64, cfg, rows=rows, budget=budget)[1:]
    out_p = kmod.run_core(core_of(Rp), kmod._tables(None, dev)[0], 64, cfg, rows=rows,
                          budget=budget)[1:]
    torch.cuda.synchronize()
    err, bad = check.max_abs_diff(R, Rp)
    if bad or not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
        fail(f"rows/budget (cs_size={cfg.cs_size}): kernel != plain on {bad}, max abs err {err}")
    print(f"check cs_size={cfg.cs_size}: 342 rows of 1024 nodes, budgets 0..69 "
          f"({int(out_k[0].sum())} instructions): byte-identical", flush=True)


def check_counting(torch, kmod, check, cfg, dev) -> None:
    """vmloop's counting instance (obs=True) against its plain version on
    the card: the sweep, 1024 random nodes, and a shuffled row list with
    per-row budgets; states, n_exec/bailed/bail_op and op_hist byte for
    byte, each row's bins totalling its n_exec."""
    from repro_torch.core.vm import vmstate as vms
    from repro_torch.kernels.vmloop.ref import core_of

    g = torch.Generator().manual_seed(cfg.cs_size + 2)
    rows = torch.arange(0, 1024, 3)[torch.randperm(342, generator=g)].to(torch.int32).to(dev)
    budget = torch.randint(0, 70, (342,), generator=g).to(torch.int32).to(dev)
    cases = [("sweep", check.sweep_states(cfg, dev)[1], None, None),
             ("random", check.random_states(cfg, 1024, seed=cfg.cs_size + 2, device=dev), None, None),
             ("rows/budget", check.random_states(cfg, 1024, seed=cfg.cs_size + 3, device=dev), rows,
              budget)]
    binned = 0
    for name, S, r, b in cases:
        P = vms.clone(S)
        out_k = kmod.vmloop_call(core_of(S), cfg.steps_per_slice, cfg, rows=r, budget=b, obs=True)[1:]
        out_p = kmod.run_core(core_of(P), kmod._tables(None, dev)[0], cfg.steps_per_slice, cfg,
                              rows=r, budget=b, obs=True)[1:]
        torch.cuda.synchronize()
        err, bad = check.max_abs_diff(S, P)
        for label, a, c in zip(("n_exec", "bailed", "bail_op", "op_hist"), out_k, out_p):
            if not torch.equal(a, c):
                bad.append(label)
                err = max(err, int((a.long() - c.long()).abs().max()))
        if bad or not torch.equal(out_k[3].sum(dim=1), out_k[0]):
            fail(f"counting instance, {name} (cs_size={cfg.cs_size}): kernel != plain on {bad}, "
                 f"max abs err {err}")
        binned += int(out_k[3].sum())
    print(f"check cs_size={cfg.cs_size}: counting instance on the sweep, 1024 random nodes and "
          f"342 rows with budgets ({binned} instructions binned): byte-identical", flush=True)


def verified(prog: str, cfg) -> bool:
    """Whether the port's static verifier admits ``prog`` from its launch
    entry.  The verifier raises IndexError on a constant ``exec`` target
    outside the code segment (the sweep's "99999 exec halt"), as the
    reference's does: such a program is not admitted."""
    from repro_torch.analysis import VERIFIED, analyze_source

    try:
        return analyze_source(prog, cfg).verdict == VERIFIED
    except IndexError:
        return False


def check_elided(torch, kmod, check, cfg, dev) -> None:
    """vmloop's checks-elided instance (elide_checks=True) against its plain
    version on the card: the sweep programs the port's verifier admits
    (where it must also equal the default instance), 1024 random nodes
    (which mostly do not verify: stack pointers leave their stacks, every
    index clamped) and a shuffled row list with per-row budgets; states and
    n_exec/bailed/bail_op byte for byte."""
    from repro_torch.core.vm import vmstate as vms
    from repro_torch.kernels.vmloop.ref import core_of

    pairs, S = check.sweep_states(cfg, dev)
    keep = [i for i, (w, p) in enumerate(pairs) if w != "fios/trap" and verified(p, cfg)]
    g = torch.Generator().manual_seed(cfg.cs_size + 4)
    rows = torch.arange(0, 1024, 3)[torch.randperm(342, generator=g)].to(torch.int32).to(dev)
    budget = torch.randint(0, 70, (342,), generator=g).to(torch.int32).to(dev)
    R = check.random_states(cfg, 1024, seed=cfg.cs_size + 5, device=dev)
    cases = [("verified sweep", vms.take_nodes(S, keep), None, None), ("random", R, None, None),
             ("rows/budget", check.random_states(cfg, 1024, seed=cfg.cs_size + 6, device=dev), rows,
              budget)]
    steps = cfg.steps_per_slice
    for name, A, r, b in cases:
        P, D = vms.clone(A), vms.clone(A)
        out_k = kmod.vmloop_call(core_of(A), steps, cfg, rows=r, budget=b, elide_checks=True)[1:]
        out_p = kmod.run_core(core_of(P), kmod._tables(None, dev)[0], steps, cfg, rows=r,
                              budget=b, elide_checks=True)[1:]
        out_d = kmod.vmloop_call(core_of(D), steps, cfg, rows=r, budget=b)[1:]
        torch.cuda.synchronize()
        err, bad = check.max_abs_diff(A, P)
        for label, a, c in zip(("n_exec", "bailed", "bail_op"), out_k, out_p):
            if not torch.equal(a, c):
                bad.append(label)
                err = max(err, int((a.long() - c.long()).abs().max()))
        if bad:
            fail(f"checks-elided instance, {name} (cs_size={cfg.cs_size}): kernel != plain on "
                 f"{bad}, max abs err {err}")
        if name == "verified sweep" and (check.max_abs_diff(A, D)[1] or not all(
                torch.equal(a, c) for a, c in zip(out_k, out_d))):
            fail(f"checks-elided instance != default instance on the verified sweep "
                 f"(cs_size={cfg.cs_size})")
    left = int(((R.dsp < 0) | (R.dsp > cfg.ds_size)).any(dim=1).sum())
    print(f"check cs_size={cfg.cs_size}: checks-elided instance on {len(keep)} verified sweep "
          f"programs (equal to the default instance), 1024 random nodes ({left} of them left "
          f"their data stack) and 342 rows with budgets: byte-identical", flush=True)


def auditor_ring(kmod, check, cfg, dev, n_nodes, run, REXAVM, vms) -> int:
    """Phase 4e (a): the ANN ring without the every-16th spawner under
    executor="auto", in turns with executor="cuda" (checks on): cuda, auto,
    auto, cuda.  The Auditor must verify every node, predict no declined
    word and plan ("cuda", elided); each auto run must launch only the
    checks-elided instance (its counter and the total move together, from
    0 before the run) and end byte for byte as the first cuda run.
    Returns the checks-elided launches of the two auto runs."""
    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n_nodes)]
    for i, vm in enumerate(nodes):
        vm.launch(vm.load(ann_program(i, n_nodes, spawners=False)))
    init = [vms.clone(vm.state) for vm in nodes]
    turns: dict = {"cuda": [], "auto": []}
    ref = None
    elided_total = 0
    for executor in ("cuda", "auto", "auto", "cuda"):
        kmod.vmloop_call.launches = kmod.vmloop_call.elide_launches = 0
        fleet, res, dt, final, split = run(executor, 1, ring=(nodes, init))
        launches, elided = kmod.vmloop_call.launches, kmod.vmloop_call.elide_launches
        if res.statuses != ["halt"] * n_nodes:
            fail(f"4e {executor}: not every node halted: {sorted(set(res.statuses))}")
        if ref is None:
            ref = (res, final)
        err, bad = check.max_abs_diff(final, ref[1])
        if bad or res.outputs != ref[0].outputs or res.rounds != ref[0].rounds:
            fail(f"4e {executor}: final states differ from the checked cuda run on {bad} "
                 f"(max abs err {err})")
        steps = int(res.steps.sum())
        if executor == "cuda":
            if elided or launches <= 0:
                fail(f"4e cuda: {launches} launches, {elided} of the checks-elided instance")
        else:
            a = fleet.analysis_stats()
            plan = (a["executor"], a["elide_checks"])
            if (plan != ("cuda", True) or a["verdicts"]["verified"] != n_nodes
                    or a["predicted_bail_words"] != []):
                fail(f"4e auto: plan {plan}, verdicts {a['verdicts']}, predicted "
                     f"{a['predicted_bail_words']}: expected ('cuda', True), all verified, none")
            if fleet.kernel_stats()["bail_hist"] != {} or not 0 < elided == launches:
                fail(f"4e auto: {launches} launches, {elided} of the checks-elided instance, "
                     f"bail_hist {fleet.kernel_stats()['bail_hist']}")
            elided_total += elided
        turns[executor].append({"s": dt, "steps_per_s": steps / dt, "launches": launches,
                                "elide_launches": elided, **split})
    mean = {ex: {k: sum(t[k] for t in v) / len(v) for k in v[0]} for ex, v in turns.items()}
    print(json.dumps({
        "phase": "auditor", "ring": "no spawners", "nodes": n_nodes, "rounds": ref[0].rounds,
        "steps": int(ref[0].steps.sum()), "plan": ["cuda", True], "verified": n_nodes,
        "predicted_bail_words": [], "bail_hist": {},
        **{f"{ex}_{k}": mean[ex][k] for ex in ("cuda", "auto")
           for k in ("steps_per_s", "rounds_ms", "start_ms", "sync_ms")},
        "auto_resolve_auto_ms": mean["auto"]["resolve_auto_ms"],
        "elide_launches": elided_total, "turns": turns, "identical_to_checked_cuda": True,
    }), flush=True)
    return elided_total


def auditor_spawners(check, n_nodes, run, results) -> None:
    """Phase 4e (b): phase 4's ring (spawners included) under
    executor="auto": the Auditor plans ("batched", elided) (declined words,
    not single-path, every entry verified), the run ends as phase 4's
    batched run, and the predicted declined words are the keys of phase
    4's cuda bail_hist."""
    fleet, res, dt, final, split = run("auto", 1)
    a = fleet.analysis_stats()
    plan = (a["executor"], a["elide_checks"])
    _, rb, _, Sb, _ = results["batched", 1]
    observed = sorted(results["cuda", 1][0].kernel_stats()["bail_hist"])
    if plan != ("batched", True) or a["verdicts"]["verified"] != n_nodes:
        fail(f"4e (b): plan {plan}, verdicts {a['verdicts']}: expected ('batched', True), all verified")
    if a["predicted_bail_words"] != observed or observed != ["rnd", "task"]:
        fail(f"4e (b): predicted {a['predicted_bail_words']}, phase 4's cuda met {observed}")
    err, bad = check.max_abs_diff(final, Sb)
    if bad or res.outputs != rb.outputs or res.rounds != rb.rounds:
        fail(f"4e (b): auto != phase 4's batched run on {bad} (max abs err {err})")
    steps = int(res.steps.sum())
    print(json.dumps({
        "phase": "auditor", "ring": "phase 4 (spawners)", "nodes": n_nodes, "plan": list(plan),
        "predicted_bail_words": a["predicted_bail_words"], "observed_bail_words": observed,
        "steps_per_s": steps / dt, **split, "identical_to_batched": True,
    }), flush=True)


class ScalarTrio:
    """Per-node scalar callbacks with the effects of the vectorized
    uart.write and fs.save, for io_mode="partial" (which calls ``fn(*args)``
    once a node): uart.write appends to the node's out stream and to
    ``stream``; fs.save returns one id for each service invocation that
    met it (the id the vectorized FSService pushes) and saves nothing."""

    def __init__(self, nodes, fleet):
        self.stream, self.fleet = [], fleet
        self._id, self._seen = 0, None
        for i, vm in enumerate(nodes):
            vm.svc_add("uart.write", functools.partial(self.uart, i, vm), args=1, num=56)
            vm.svc_add("fs.save", self.fs, args=1, ret=1, num=57)

    def uart(self, i, vm, v):
        vm.out_stream.append(v)
        self.stream.append((i, v))

    def fs(self, tag):
        if self._seen != self.fleet.io_service.services:
            self._seen = self.fleet.io_service.services
            self._id += 1
        return self._id


def executive_setup(cfg, dev, n, main=None, saver=None):
    """Phase 4f's nodes: the ring without spawners as task 0 (or
    ``main(i)``), and the sampler, fs.save (``{i} fs.save out``, or
    ``saver``) and second programs compiled into each node (their entries;
    no task launched).  Returns (nodes, initial states, entries)."""
    import tempfile

    from repro_torch.core.vm import REXAVM, vmstate as vms
    from repro_torch.exec import install_services
    from repro_torch.resilience import CheckpointManager

    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n)]
    with tempfile.TemporaryDirectory() as tmp:        # registers fs.save's name only
        install_services(nodes, CheckpointManager(tmp))
    entries = []
    for i, vm in enumerate(nodes):
        vm.launch(vm.load(main(i) if main else ann_program(i, n, spawners=False)))
        entries.append((vm.load(SAMPLER).entry, vm.load(saver or f"{i} fs.save out").entry,
                        vm.load(SECOND).entry))
    return nodes, [vms.clone(vm.state) for vm in nodes], entries


def executive_run(torch, cfg, dev, ring, executor, io_mode, tmp, start_only: bool = False,
                  max_rounds: int = 200, mesh=None):
    """One FleetVM.run of phase 4f's fleet from its initial states: fresh
    services (a CheckpointManager under ``tmp``), the spawns through
    Executive.spawn (timed: the WCET admission), then start / rounds / sync
    as phase 4's ``run``, at most ``max_rounds``.  With ``start_only`` it
    returns the started fleet; with ``mesh`` the fleet is sharded over it
    (phase 11)."""
    from repro_torch.core.vm import FleetVM, vmstate as vms
    from repro_torch.exec import Executive, ExecutiveConfig, install_services
    from repro_torch.resilience import CheckpointManager

    nodes, init, entries = ring
    for vm, st in zip(nodes, init):
        vm.state = vms.clone(st)
        vm.out_stream.clear()
    where = {"mesh": mesh} if mesh is not None else {"device": dev}
    fleet = FleetVM(nodes=nodes, executor=executor, executive=ExecutiveConfig(),
                    io_mode=io_mode, **where)
    mgr = CheckpointManager(os.path.join(tmp, f"{executor}_{io_mode}{'_mesh' if mesh else ''}"),
                            keep=2)
    svcs = install_services(nodes, mgr)
    scalar = ScalarTrio(nodes, fleet) if io_mode == "partial" else None
    ex = Executive(fleet)
    t = time.perf_counter()
    for i, (sampler, saver, second) in enumerate(entries):
        ex.spawn(i, sampler, prio=1, deadline=SAMPLER_DEADLINE_MS)
        if i % 16 == 0:
            ex.spawn(i, saver)
        if i % 64 == 0:
            ex.spawn(i, second, prio=1)
            ex.spawn(i, sampler, prio=1, deadline=REJECTED_DEADLINE_MS)
    admit_ms = 1e3 * (time.perf_counter() - t)
    if start_only:
        fleet.start()
        return fleet
    split = {"admit_ms": admit_ms, "io_ms": 0.0, "io_calls": 0}
    service, one = fleet._service_host_io, {}

    def service_io(mask):                     # each call timed, summed into io_ms
        out = synchronized(torch, service, one, "ms")(mask)
        split["io_ms"] += one["ms"]
        split["io_calls"] += 1
        return out

    fleet._service_host_io = service_io
    res, dt, final = timed_run(torch, fleet, split, max_rounds=max_rounds)
    uart = scalar.stream if scalar else svcs.uart.stream
    return {"fleet": fleet, "res": res, "dt": dt, "final": final, "split": split, "uart": uart,
            "outs": [list(vm.out_stream) for vm in nodes], "ckpt": mgr.latest_step()}


def same_run(check, a, b) -> list:
    """What differs between two phase 4f runs (states, out streams, the
    UART stream, rounds, checkpoint ids)."""
    err, bad = check.max_abs_diff(a["final"], b["final"])
    for key in ("outs", "uart"):
        if a[key] != b[key]:
            bad.append(key)
    if a["res"].rounds != b["res"].rounds:
        bad.append("rounds")
    return bad


def exec_stats(run) -> dict:
    e = run["fleet"].executive_stats()
    e.pop("executor")
    return e


def executive_phase(torch, kmod, check, cfg, dev, n_nodes, run) -> tuple:
    """Phase 4f: returns vmloop's launches in the first cuda run and the
    fleet's nodes (``executive_setup``'s, which phase 11 runs again).
    ``run`` is phase 4's, which times the baseline (the ring alone, no
    Executive)."""
    import tempfile

    t0 = time.perf_counter()
    ring = executive_setup(cfg, dev, n_nodes)
    setup_s = time.perf_counter() - t0
    spawns = (n_nodes, len(range(0, n_nodes, 16)), len(range(0, n_nodes, 64)))
    runs, turns = {}, {"executive": [], "baseline": []}
    nodes, init, _ = ring
    with tempfile.TemporaryDirectory() as tmp:
        launches = None
        for turn in ("executive", "baseline", "baseline", "executive"):
            if turn == "executive":
                kmod.vmloop_call.launches = 0
                er = executive_run(torch, cfg, dev, ring, "cuda", "vector", tmp)
                if launches is None:
                    launches, runs["cuda"] = kmod.vmloop_call.launches, er
                elif same_run(check, er, runs["cuda"]) or exec_stats(er) != exec_stats(runs["cuda"]):
                    fail("4f: the two cuda Executive runs differ")
                steps = int(er["res"].steps.sum())
                turns[turn].append({"s": er["dt"], "steps_per_s": steps / er["dt"],
                                    "ms_per_round": 1e3 * er["dt"] / er["res"].rounds,
                                    **er["split"]})
                continue
            _, res, dt, _, split = run("cuda", 1, ring=(nodes, init))
            if res.statuses != ["halt"] * n_nodes:
                fail(f"4f baseline: not every node halted: {sorted(set(res.statuses))}")
            steps = int(res.steps.sum())
            turns[turn].append({"s": dt, "steps_per_s": steps / dt, "rounds": res.rounds,
                                "ms_per_round": 1e3 * dt / res.rounds, **split})
        rc = runs["cuda"]
        res = rc["res"]
        if res.statuses != ["halt"] * n_nodes:
            fail(f"4f: not every node halted: {sorted(set(res.statuses))}")
        ec = exec_stats(rc)
        if (ec["spawns_admitted"] != sum(spawns) or ec["spawns_rejected"] != spawns[2]
                or ec["preemptions"] <= 0 or ec["svc_scalar_calls"] != 0):
            fail(f"4f: executive_stats {ec}")
        if len(rc["uart"]) != n_nodes + spawns[2] or rc["ckpt"] is None:
            fail(f"4f: {len(rc['uart'])} UART writes, checkpoint {rc['ckpt']}")
        if launches < 8 * res.rounds:
            fail(f"4f: vmloop launched {launches} times over {res.rounds} rounds (< 8 a round)")
        # (a) batched on the card
        runs["batched"] = executive_run(torch, cfg, dev, ring, "batched", "vector", tmp)
        bad = same_run(check, rc, runs["batched"])
        if bad or exec_stats(runs["batched"]) != ec or runs["batched"]["ckpt"] != rc["ckpt"]:
            fail(f"4f (a): cuda != batched on {bad}")
        # (b) the per-node service under cuda
        runs["partial"] = executive_run(torch, cfg, dev, ring, "cuda", "partial", tmp)
        bad = same_run(check, rc, runs["partial"])
        met = 2                                          # uart.write, fs.save
        if bad or ec["svc_batches"] > rc["fleet"].io_service.services * met:
            fail(f"4f (b): vector != partial on {bad}, {ec['svc_batches']} batches over "
                 f"{rc['fleet'].io_service.services} services")
        # round 0 by layer
        marks = []

        def mark(layer):
            torch.cuda.synchronize()
            marks.append((layer, time.perf_counter()))

        fleet = executive_run(torch, cfg, dev, ring, "cuda", "vector", tmp, start_only=True)
        mark("start")
        fleet.kernels.round_exec(fleet._S, mark)
        ms: dict = {}
        for (_, a), (layer, b) in zip(marks, marks[1:]):
            ms[layer] = ms.get(layer, 0.0) + 1e3 * (b - a)
        kernel_launches = sum(layer == "kernel" for layer, _ in marks)
        del fleet
        # (c) the Oracle on a 256-node copy
        small = executive_setup(cfg, dev, ORACLE_NODES)
        ro = executive_run(torch, cfg, dev, small, "oracle", "vector", tmp)
        rcs = executive_run(torch, cfg, dev, small, "cuda", "vector", tmp)
        bad = same_run(check, ro, rcs)
        if bad or exec_stats(ro) != exec_stats(rcs):
            fail(f"4f (c): oracle != cuda on {bad} at {ORACLE_NODES} nodes")
    steps = int(res.steps.sum())
    mean = {k: {f: sum(t[f] for t in v) / len(v) for f in ("s", "steps_per_s", "ms_per_round",
                                                           "start_ms", "rounds_ms", "sync_ms")}
            for k, v in turns.items()}
    print(json.dumps({
        "phase": "executive", "nodes": n_nodes, "quantum": 32, "slices": 8, "io_mode": "vector",
        "setup_s": setup_s, "rounds": res.rounds, "steps": steps,
        "start_ms": rc["split"]["start_ms"], "rounds_ms": rc["split"]["rounds_ms"],
        "sync_ms": rc["split"]["sync_ms"], "io_ms": rc["split"]["io_ms"],
        "io_calls": rc["split"]["io_calls"], "ms_per_round": 1e3 * rc["dt"] / res.rounds,
        "steps_per_s": steps / rc["dt"], "admit_ms": rc["split"]["admit_ms"],
        "task_switches": ec["task_switches"], "preemptions": ec["preemptions"],
        "spawns_admitted": ec["spawns_admitted"], "spawns_rejected": ec["spawns_rejected"],
        "syscalls": ec["syscalls"], "svc_batches": ec["svc_batches"],
        "io_services": rc["fleet"].io_service.services, "checkpoint": rc["ckpt"],
        "vmloop_launches": launches, "launches_per_round": launches / res.rounds,
        "kernel_stats": {k: v for k, v in rc["fleet"].kernel_stats().items() if k != "executor"},
        "batched_steps_per_s": steps / runs["batched"]["dt"],
        "partial_steps_per_s": steps / runs["partial"]["dt"],
        "oracle_nodes": ORACLE_NODES, "oracle_s": ro["dt"], "oracle_cuda_s": rcs["dt"],
        "identical": ["cuda=batched", "vector=partial", "oracle=cuda"],
    }), flush=True)
    print(json.dumps({
        "phase": "executive_breakdown", "round": 0, "schedule_prio_ms": ms["schedule_prio"],
        "kernel_ms": ms["kernel"], "kernel_launches": kernel_launches,
        "kernel_ms_per_launch": ms["kernel"] / kernel_launches, "tail_ms": ms.get("tail", 0.0),
        "preempt_ms": ms["preempt"], "route_warp_ms": ms["route"],
        "round_ms": 1e3 * (marks[-1][1] - marks[0][1]),
    }), flush=True)
    print(json.dumps({"phase": "executive_baseline", "turns": turns, "mean": mean,
                      "executive_over_baseline_s": mean["executive"]["s"] / mean["baseline"]["s"]}),
          flush=True)
    return launches, ring


def group_growth(engine, before: dict) -> dict:
    """The trace engine's program groups that grew since ``before`` (their
    node-slices then), with the node-slices each grew by."""
    return {k: g["node_slices"] - before.get(k, 0) for k, g in engine.group_stats.items()
            if g["node_slices"] != before.get(k, 0)}


def node_slices(engine) -> dict:
    return {k: g["node_slices"] for k, g in engine.group_stats.items()}


class TailSpy:
    """While on, counts vmloop's launches by kind: the trace tail's first
    launch of a slice (every node, a budget tensor), its relaunches over
    row lists, and any call of the kernel's plain version; the first tail
    launch's inputs are kept (phase 5 times them)."""

    def __init__(self, kmod):
        from repro_torch.kernels.vmloop import ops

        self.ops, self.kmod = ops, kmod
        self.real_call, self.real_plain = ops.vmloop_call, kmod.run_core
        self.counts = {"tail_first": 0, "rows": 0, "plain": 0}
        self.first = None

    def call(self, core, steps, cfg, isa=None, rows=None, budget=None, **kw):
        if rows is None and budget is not None:
            self.counts["tail_first"] += 1
            if self.first is None:
                self.first = (type(core)(*[x.clone() for x in core]), budget.clone())
        elif rows is not None:
            self.counts["rows"] += 1
        return self.real_call(core, steps, cfg, isa, rows=rows, budget=budget, **kw)

    def plain(self, *args, **kw):
        self.counts["plain"] += 1
        return self.real_plain(*args, **kw)

    def __enter__(self):
        self.ops.vmloop_call, self.kmod.run_core = self.call, self.plain
        return self

    def __exit__(self, *exc):
        self.ops.vmloop_call, self.kmod.run_core = self.real_call, self.real_plain


def trace_phase(torch, kmod, check, cfg, dev, n_nodes) -> tuple:
    """Phase 4g (a) and (b): TRACE_PROGRAM on every node (one program
    group, the full-fleet path).  Round 0 by layer through ``mark`` (cold:
    its recording falls in it) and the host syncs of one specialized slice
    (``torch.cuda.set_sync_debug_mode``); then TRACE_ROUNDS rounds a run in
    turns, trace, cuda, trace, cuda, then batched, each equal to the first
    byte for byte; trace_stats() one group grown by n_nodes a round,
    specialized_frac > 0.9, guard_exits <= total_steps, vmloop launched
    only as the tail (a budget tensor) and never its plain version.  (b) the
    same fleet under "auto": plan ("trace", False), predicted ["rnd"],
    n_nodes AOT branch sets, nothing built during the run, the same bytes.
    Returns the trace runs' vmloop launches, round 0's first tail launch
    (core, budget) and the fleet's (nodes, initial states), which phase 11
    runs again."""
    import warnings
    from collections import Counter

    from repro_torch.core.vm import FleetVM, REXAVM, vmstate as vms

    t0 = time.perf_counter()
    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n_nodes)]
    for vm in nodes:
        vm.launch(vm.load(TRACE_PROGRAM))
    init = [vms.clone(vm.state) for vm in nodes]
    setup_s = time.perf_counter() - t0

    def fresh(executor):
        for vm, st in zip(nodes, init):
            vm.state = vms.clone(st)
        return FleetVM(nodes=nodes, executor=executor, device=dev)

    # round 0 by layer, and the first tail launch's inputs
    fleet = fresh("trace")
    fleet.start()
    S, ex = fleet._S, fleet.kernels.executor
    eng = ex.engine
    marks = []

    def mark(layer):
        torch.cuda.synchronize()
        marks.append((layer, time.perf_counter()))

    steps0, passes0, rec0 = S.steps.clone(), ex.spec_passes, eng.traces_recorded
    with TailSpy(kmod) as spy:
        mark("start")
        ex.run_slice_batched(S, cfg.steps_per_slice, mark)
        fleet.kernels.post_slice(S, steps0)
        mark("route")
    ms: dict = {}
    for (_, a), (layer, b) in zip(marks, marks[1:]):
        ms[layer] = ms.get(layer, 0.0) + 1e3 * (b - a)
    count = Counter(layer for layer, _ in marks)
    spec_steps = ex.spec_passes - passes0
    tail = spy.first
    if spy.counts["plain"] or tail is None:
        fail(f"4g: round 0's tail: {spy.counts}")
    # the host syncs of one specialized slice, as torch's sync debug mode sees them
    passes1 = ex.spec_passes
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ex.run_slice_batched(S, cfg.steps_per_slice)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    profile = profile_spec_slice(torch, ex, S, cfg.steps_per_slice)
    # what the row helpers avoid: a device tensor built from a Python
    # number, and an indexed store of one, as the sync debug mode sees them
    idx = torch.zeros(4, dtype=torch.long, device=dev)
    cells = torch.zeros(4, dtype=torch.int32, device=dev)
    scalar_syncs = []
    for op in (lambda: torch.as_tensor(7, dtype=torch.int32, device=dev),
               lambda: cells.__setitem__(idx, 7)):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                op()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        scalar_syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    breakdown = {
        "phase": "trace_breakdown", "round": 0, "nodes": n_nodes,
        "schedule_ms": ms["schedule"], "probe_ms": ms["probe"],
        "record_ms": ms.get("record", 0.0), "traces_recorded": eng.traces_recorded - rec0,
        "spec_ms": ms["spec"], "spec_steps": spec_steps,
        "ms_per_spec_step": ms["spec"] / max(spec_steps, 1),
        "kernel_ms": ms["kernel"], "kernel_launches": count["kernel"],
        "handback_ms": ms.get("tail", 0.0), "handbacks": count["tail"],
        "preempt_ms": ms["preempt"], "route_warp_ms": ms["route"],
        "round_ms": 1e3 * (marks[-1][1] - marks[0][1]),
        "tail_budgets": [int(tail[1].min()), int(tail[1].max())],
        "syncs_per_spec_step": syncs / max(ex.spec_passes - passes1, 1),
        "syncs_as_tensor_and_setitem_of_a_number": scalar_syncs, **profile,
    }
    del fleet, S
    # (a) the runs in turns
    turns: dict = {}
    ref = None
    launches = 0
    stats = None
    for executor in ("trace", "cuda", "trace", "cuda", "batched"):
        fleet = fresh(executor)
        before = node_slices(eng)
        split: dict = {}
        kmod.vmloop_call.launches = 0
        with TailSpy(kmod) as spy:
            res, dt, final = timed_run(torch, fleet, split, max_rounds=TRACE_ROUNDS)
        ran = kmod.vmloop_call.launches
        if res.rounds != TRACE_ROUNDS:
            fail(f"4g (a) {executor}: {res.rounds} rounds, expected {TRACE_ROUNDS}")
        if ref is None:
            ref = final
        err, bad = check.max_abs_diff(final, ref)
        if bad:
            fail(f"4g (a): {executor} != the first trace run on {bad} (max abs err {err})")
        steps = int(res.steps.sum())
        if executor == "trace":
            stats = fleet.trace_stats()
            grown = group_growth(eng, before)
            if (list(grown.values()) != [n_nodes * TRACE_ROUNDS] or stats["specialized_frac"] <= 0.9
                    or stats["guard_exits"] > stats["total_steps"]):
                fail(f"4g (a): groups grew {grown}, trace_stats {stats}")
            if (spy.counts["plain"] or spy.counts["tail_first"] != TRACE_ROUNDS
                    or ran != spy.counts["tail_first"] + spy.counts["rows"]):
                fail(f"4g (a): vmloop {ran} launches, {spy.counts}: only the tail, a budget "
                     "tensor each slice, never the plain version")
            launches += ran
        turns.setdefault(executor, []).append({"s": dt, "steps_per_s": steps / dt,
                                               "launches": ran, **split})
    if launches <= 0:
        fail("4g: the trace path launched vmloop no time")
    mean = {ex_: {k: sum(t[k] for t in v) / len(v) for k in v[0]} for ex_, v in turns.items()}
    print(json.dumps({
        "phase": "trace", "nodes": n_nodes, "rounds": TRACE_ROUNDS, "setup_s": setup_s,
        "steps": steps, **{f"{ex_}_{k}": mean[ex_][k] for ex_ in mean
                           for k in ("steps_per_s", "start_ms", "rounds_ms", "sync_ms")},
        "trace_over_cuda": mean["trace"]["steps_per_s"] / mean["cuda"]["steps_per_s"],
        "trace_stats": {k: v for k, v in stats.items() if k != "executor"},
        "trace_launches": launches, "turns": turns,
        "identical": ["trace=cuda=batched"],
    }), flush=True)
    print(json.dumps(breakdown), flush=True)
    # (b) under auto
    fleet = fresh("auto")
    split = {}
    fleet._resolve_auto = synchronized(torch, fleet._resolve_auto, split, "auditor_ms")
    fleet.sync = synchronized(torch, fleet.sync, split, "sync_ms")
    synchronized(torch, fleet.start, split, "start_ms")()
    a = fleet.analysis_stats()
    compiled = eng.traces_compiled
    torch.cuda.synchronize()
    t = time.perf_counter()
    kmod.vmloop_call.launches = 0
    with TailSpy(kmod) as spy:
        res = fleet.run(max_rounds=TRACE_ROUNDS)
    dt = time.perf_counter() - t
    launches += kmod.vmloop_call.launches
    final = vms.stack_states([vm.state for vm in nodes])
    plan = (a["executor"], a["elide_checks"])
    if (plan != ("trace", False) or a["predicted_bail_words"] != ["rnd"]
            or a["aot_branch_sets"] != n_nodes):
        fail(f"4g (b): plan {plan}, predicted {a['predicted_bail_words']}, "
             f"{a['aot_branch_sets']} AOT branch sets")
    err, bad = check.max_abs_diff(final, ref)
    if bad or eng.traces_compiled != compiled or spy.counts["plain"]:
        fail(f"4g (b): auto != the trace run on {bad}; built {eng.traces_compiled - compiled} "
             f"during the run; {spy.counts}")
    ts = fleet.trace_stats()
    print(json.dumps({
        "phase": "trace_auto", "nodes": n_nodes, "rounds": res.rounds, "plan": list(plan),
        "predicted_bail_words": a["predicted_bail_words"], "aot_branch_sets": a["aot_branch_sets"],
        "traces_compiled": ts["traces_compiled"], "built_during_run": 0,
        "steps_per_s": int(res.steps.sum()) / (dt + split["start_ms"] / 1e3),
        "auditor_ms": split["auditor_ms"], "start_ms": split["start_ms"],
        "rounds_ms": 1e3 * dt - split["sync_ms"], "sync_ms": split["sync_ms"],
        "specialized_frac": ts["specialized_frac"], "identical_to_trace": True,
    }), flush=True)
    return launches, tail, (nodes, init)


def profile_spec_slice(torch, ex, S, steps: int) -> dict:
    """One more slice of the trace engine under torch.profiler: kernels
    and device ms a specialized step, the device's busy share of the
    slice's wall time, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    passes = ex.spec_passes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        ex.run_slice_batched(S, steps)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    spec = max(ex.spec_passes - passes, 1)
    kernels = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        kernels[ev.key] = (kernels.get(ev.key, (0, 0.0))[0] + ev.count,
                           kernels.get(ev.key, (0, 0.0))[1] + us)
    busy = sum(us for _, us in kernels.values())
    if busy <= 0:
        return {"profile": "torch.profiler recorded no device time (not measured)"}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    return {"profiled_wall_ms_per_spec_step": wall_us / 1e3 / spec,
            "kernels_per_spec_step": sum(n for n, _ in kernels.values()) / spec,
            "device_ms_per_spec_step": busy / 1e3 / spec, "device_busy_share": busy / wall_us,
            "top_kernels_device_ms": {k[:60]: round(us / 1e3, 3) for k, (_, us) in top}}


def trace_executive(torch, check, cfg, dev, n_nodes) -> None:
    """Phase 4g (c): phase 4f's Executive fleet (the spawns, the services,
    io_mode="vector") with TRACE_PROGRAM as task 0 and one fs.save program
    for every node, so that all code segments are equal: a handful of
    program groups, one per (entry pc) pattern.  TRACE_EXEC_ROUNDS rounds
    under "trace" against "cuda": states, out streams, the UART stream,
    checkpoints, executive_stats() and trace_stats()["exec_slices"]."""
    import tempfile

    t0 = time.perf_counter()
    ring = executive_setup(cfg, dev, n_nodes, main=lambda i: TRACE_PROGRAM, saver="7 fs.save out")
    setup_s = time.perf_counter() - t0
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for executor in ("trace", "cuda"):
            runs[executor] = executive_run(torch, cfg, dev, ring, executor, "vector", tmp,
                                           max_rounds=TRACE_EXEC_ROUNDS)
    rt, rc = runs["trace"], runs["cuda"]
    bad = same_run(check, rt, rc)
    et, ts = exec_stats(rt), rt["fleet"].trace_stats()
    if bad or et != exec_stats(rc) or rt["ckpt"] != rc["ckpt"]:
        fail(f"4g (c): trace != cuda under the Executive on {bad}")
    if (ts["exec_slices"] != et["exec_slices"] or et["exec_slices"] != TRACE_EXEC_ROUNDS * 8
            or ts["spec_steps"] <= 0):
        fail(f"4g (c): trace_stats {ts}, executive_stats {et}")
    steps = int(rt["res"].steps.sum())
    print(json.dumps({
        "phase": "trace_executive", "nodes": n_nodes, "rounds": rt["res"].rounds,
        "setup_s": setup_s, "steps": steps,
        **{f"{ex_}_{k}": r["split"][k] for ex_, r in runs.items()
           for k in ("start_ms", "rounds_ms", "sync_ms", "admit_ms", "io_ms")},
        **{f"{ex_}_steps_per_s": steps / r["dt"] for ex_, r in runs.items()},
        "groups": len(ts["groups"]), "exec_slices": ts["exec_slices"],
        "trace_stats": {k: v for k, v in ts.items() if k not in ("executor", "groups")},
        "task_switches": et["task_switches"], "preemptions": et["preemptions"],
        "syscalls": et["syscalls"], "identical_to_cuda": True,
    }), flush=True)


def trace_ring(check, cfg, dev, run, REXAVM, vms) -> None:
    """Phase 4g (d): phase 4's ring (spawners: task and rnd) at
    TRACE_RING_NODES nodes, one program a node, under "trace" (the
    per-group gather and scatter, the recorder over every program) against
    "cuda", byte for byte."""
    n = TRACE_RING_NODES
    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n)]
    for i, vm in enumerate(nodes):
        vm.launch(vm.load(ann_program(i, n)))
    init = [vms.clone(vm.state) for vm in nodes]
    out = {ex_: run(ex_, 1, ring=(nodes, init)) for ex_ in ("trace", "cuda")}
    (ft, rt, dtt, St, _), (_, rc, dtc, Sc, _) = out["trace"], out["cuda"]
    err, bad = check.max_abs_diff(St, Sc)
    if bad or rt.outputs != rc.outputs or rt.rounds != rc.rounds or rt.statuses != ["halt"] * n:
        fail(f"4g (d): trace ring != cuda ring on {bad} (max abs err {err}) at {n} nodes")
    ts = ft.trace_stats()
    print(json.dumps({
        "phase": "trace_ring", "nodes": n, "rounds": rt.rounds, "steps": int(rt.steps.sum()),
        "trace_s": dtt, "cuda_s": dtc, "traces_recorded": ts["traces_recorded"],
        "spec_steps": ts["spec_steps"], "guard_exits": ts["guard_exits"],
        "specialized_frac": ts["specialized_frac"], "identical_to_cuda": True,
    }), flush=True)


def trace_monitor_and_nodes(torch, check, dev, REXAVM, vms) -> None:
    """Phase 4g (e): FleetServeMonitor(n=64, executor="trace") for three
    steps against the "cuda" monitor (reports equal, one program group
    grown); then REXAVM(backend="cuda") and REXAVM(backend="trace") on the
    card over HOST_IO, byte for byte against backend="oracle", the cuda
    backend's kernel counters checked."""
    from repro_torch.config import VMConfig
    from repro_torch.serve import FleetServeMonitor, ServeStats

    reports, grown = {}, None
    for executor in ("trace", "cuda"):
        mon = FleetServeMonitor(n=MONITOR_NODES, executor=executor, device=dev)
        eng = mon.fleet.kernels.executor.engine if executor == "trace" else None
        before = node_slices(eng) if eng else None
        for step in range(1, 4):
            mon(ServeStats(steps=step, prefill_tokens=SERVE_BATCH * PROMPT_LEN,
                           decode_tokens=SERVE_BATCH * step))
        reports[executor] = mon.reports()
        if eng:
            grown = group_growth(eng, before)
    if reports["trace"] != reports["cuda"] or len(grown) != 1:
        fail(f"4g (e): trace monitor reports differ or groups grew {grown}")
    cfg = VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4)
    nodes_out = {}
    for backend in ("cuda", "trace"):
        for prog, fios in HOST_IO:
            pair = {}
            for b in (backend, "oracle"):
                vm = REXAVM(cfg, backend=b, device=dev)
                if fios:
                    vm.svc_add("seven", lambda: 7, args=0, ret=1)
                pair[b] = (vm, vm.run(vm.load(prog), max_slices=100))
            (vb, rb), (vo, ro) = pair[backend], pair["oracle"]
            err, bad = check.max_abs_diff(vms.stack1(vb.state), vms.stack1(vo.state))
            if bad or (rb.status, rb.output, rb.steps) != (ro.status, ro.output, ro.steps) \
                    or vb.out_stream != vo.out_stream:
                fail(f"4g (e): REXAVM(backend={backend!r}) != oracle on {prog!r}: {bad}")
            ex = vb.executor
            if backend == "cuda":
                ok = ex.kernel_steps > 0 and ex.kernel_steps + ex.fallback_steps == rb.steps
                if fios:
                    ok &= ex.bailouts >= 1 and ex.bail_hist.get("fios/trap", 0) >= 1
                if "task" in prog:
                    ok &= ex.bail_hist.get("task", 0) >= 1
                if not ok:
                    fail(f"4g (e): cuda backend counters on {prog!r}: kernel {ex.kernel_steps}, "
                         f"fallback {ex.fallback_steps}, bailouts {ex.bailouts}, {ex.bail_hist}")
                nodes_out[prog] = {"kernel_steps": ex.kernel_steps, "bailouts": ex.bailouts,
                                   "bail_hist": ex.bail_hist}
    print(json.dumps({"phase": "trace_monitor_nodes", "monitor_nodes": MONITOR_NODES,
                      "monitor_groups_grown": grown, "reports_equal_cuda": True,
                      "single_node_cuda": nodes_out, "single_node_equal_oracle": ["cuda", "trace"]}),
          flush=True)


# ---------------------------------------------------------------------------
# Phase 11: the sharded fleet
# ---------------------------------------------------------------------------

def shard_drive(torch, kmod, fleet_ring, mesh=None, executor="cuda", obs=None,
                max_rounds: int = 200, dev=None) -> dict:
    """One FleetVM.run of a fleet (``(nodes, initial states)``) from its
    initial states, on ``mesh`` or meshless on ``dev``, split as phase 4's
    ``run``; with vmloop's launches in the run."""
    from repro_torch.core.vm import FleetVM, vmstate as vms

    nodes, init = fleet_ring
    for vm, st in zip(nodes, init):
        vm.state = vms.clone(st)
        vm.out_stream.clear()
    where = {"mesh": mesh} if mesh is not None else {"device": dev or torch.device("cuda")}
    fleet = FleetVM(nodes=nodes, executor=executor, obs=obs, **where)
    split: dict = {}
    l0 = kmod.vmloop_call.launches
    names = ("start", "sync") + (("_resolve_auto",) if executor == "auto" else ())
    res, dt, final = timed_run(torch, fleet, split, names, max_rounds=max_rounds)
    return {"fleet": fleet, "res": res, "dt": dt, "final": final, "split": split,
            "launches": kmod.vmloop_call.launches - l0}


def shard_diff(check, a: dict, b: dict) -> list:
    """What differs between two runs: states, outputs, rounds, steps, out
    streams and the kernel's counters."""
    err, bad = check.max_abs_diff(a["final"], b["final"])
    ra, rb = a["res"], b["res"]
    for name, x, y in (("outputs", ra.outputs, rb.outputs), ("rounds", ra.rounds, rb.rounds),
                       ("statuses", ra.statuses, rb.statuses),
                       ("steps", ra.steps.tolist(), rb.steps.tolist()),
                       ("out_streams", [vm.out_stream for vm in a["fleet"].nodes],
                        [vm.out_stream for vm in b["fleet"].nodes]),
                       ("kernel_stats", a["fleet"].kernel_stats(), b["fleet"].kernel_stats())):
        if x != y:
            bad.append(name)
    return bad


def shard_timing(runs: list) -> dict:
    """Means over the runs of one kind: rounds ms, start / sync ms and
    steps/s (host clock, the card synchronized)."""
    steps = int(runs[0]["res"].steps.sum())
    return {"runs": len(runs), "rounds": runs[0]["res"].rounds,
            "rounds_ms": sum(r["split"]["rounds_ms"] for r in runs) / len(runs),
            "start_ms": sum(r["split"]["start_ms"] for r in runs) / len(runs),
            "sync_ms": sum(r["split"]["sync_ms"] for r in runs) / len(runs),
            "steps_per_s": sum(steps / r["dt"] for r in runs) / len(runs),
            "launches": runs[0]["launches"], "turns_s": [r["dt"] for r in runs]}


def sharded_phase(torch, kmod, check, cfg, n_nodes, ring, phase4, exec_ring,
                  firmware_ring) -> int:
    """Phase 11: the sharded fleet (see the module's docstring).  ``ring``
    is phase 4's (nodes, initial states), ``phase4`` its meshless cuda run
    at service_every=1, ``exec_ring`` phase 4f's nodes and
    ``firmware_ring`` phase 4g's firmware fleet.  Returns vmloop's launches in the phase."""
    import tempfile

    from repro_torch.core.vm import REXAVM, vmstate as vms
    from repro_torch.launch.mesh import make_node_mesh
    from repro_torch.obs import ObsConfig
    from repro_torch.serve import FleetServeMonitor, ServeStats

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    meshes = {"mesh1": make_node_mesh(), "mesh4": make_node_mesh(SHARDS, device="cuda")}
    kmod.vmloop_call.launches = 0
    base = {"fleet": phase4[0], "res": phase4[1], "final": phase4[3]}
    spawners = len(range(0, n_nodes, 16))

    # (a) phase 4's ring on one shard a card and on four shards of the card
    runs: dict = {"meshless": [], "mesh1": [], "mesh4": []}
    route = {}
    for name in ("meshless", "mesh1", "mesh4", "mesh4", "mesh1", "meshless"):
        r = shard_drive(torch, kmod, ring, meshes.get(name))
        bad = shard_diff(check, r, base)
        if bad or r["fleet"].kernel_stats()["bail_hist"] != {"task": spawners, "rnd": spawners}:
            fail(f"11 (a): the ring on {name} != phase 4's meshless cuda run on {bad}")
        spec = r["fleet"].node_spec
        if spec != ((("node",)) if name != "meshless" else ()):
            fail(f"11 (a): {name} has node spec {spec}")
        if name != "meshless":
            stats = r["fleet"].kernels.route.stats
            route[name] = {k: v / stats["rounds"] for k, v in stats.items() if k != "rounds"}
        runs[name].append(r)
        del r
    timing = {name: shard_timing(rs) for name, rs in runs.items()}
    rounds = timing["meshless"]["rounds"]
    if timing["mesh1"]["launches"] != timing["meshless"]["launches"] \
            or timing["mesh4"]["launches"] < SHARDS * rounds:
        fail(f"11 (a): vmloop launches {[(k, t['launches']) for k, t in timing.items()]} "
             f"over {rounds} rounds")
    del runs
    print(json.dumps({
        "phase": "sharded_ring", "nodes": n_nodes, "shards": {"mesh1": 1, "mesh4": SHARDS},
        "executor": "cuda", "steps": int(phase4[1].steps.sum()), **timing,
        "descriptor_copies_per_round": route, "identical_to_phase4": True,
    }), flush=True)

    # (b) partial IO at full width on the four shards
    t0 = time.perf_counter()
    io_nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n_nodes)]
    for i, vm in enumerate(io_nodes):
        if i % PARTIAL_IO_EVERY == 0:
            vm.dios_add("ready", 1)
            vm.svc_add("ping", functools.partial(vm.dios_write, "ready", [1]))
            vm.launch(vm.load("ping 1000 1 ready await drop 5 . halt"))
        else:
            vm.launch(vm.load("0 50 0 do 1+ loop . halt"))
    io_ring = (io_nodes, [vms.clone(vm.state) for vm in io_nodes])
    io_setup_s = time.perf_counter() - t0
    rm = shard_drive(torch, kmod, io_ring, meshes["mesh4"])
    rb = shard_drive(torch, kmod, io_ring)
    fm, fb = rm["fleet"], rb["fleet"]
    per_node = vms.state_nbytes(io_ring[1][0])
    svc = fm.io_service
    served = len(range(0, n_nodes, PARTIAL_IO_EVERY))
    bad = shard_diff(check, rm, rb)
    if (bad or rm["res"].statuses != ["halt"] * n_nodes or svc.nodes_serviced < served
            or fm.io_d2h_bytes != svc.nodes_serviced * per_node
            or fm.transfer_stats() != fb.transfer_stats() or (fm.h2d, fm.d2h) != (1, 1)):
        fail(f"11 (b): partial IO on {SHARDS} shards: {bad}, {fm.transfer_stats()}")
    print(json.dumps({
        "phase": "sharded_partial_io", "nodes": n_nodes, "shards": SHARDS, "setup_s": io_setup_s,
        "io_services": svc.services, "io_nodes_serviced": svc.nodes_serviced,
        "io_d2h_bytes": fm.io_d2h_bytes, "node_bytes": per_node,
        "full_state_bytes": per_node * n_nodes, "mesh4_s": rm["dt"], "meshless_s": rb["dt"],
        "identical_to_meshless": True,
    }), flush=True)
    del rm, rb, fm, fb, svc

    # (c) a fleet the mesh does not divide (the first REPLICATED_NODES of
    # (b)'s): replicated, one copy, as many launches as meshless
    rep_ring = (io_ring[0][:REPLICATED_NODES], io_ring[1][:REPLICATED_NODES])
    rm = shard_drive(torch, kmod, rep_ring, meshes["mesh4"])
    rb = shard_drive(torch, kmod, rep_ring)
    bad = shard_diff(check, rm, rb)
    if bad or rm["fleet"].node_spec != () or rm["launches"] != rb["launches"] \
            or rm["res"].statuses != ["halt"] * REPLICATED_NODES:
        fail(f"11 (c): {REPLICATED_NODES} nodes on {SHARDS} shards: {bad}, spec "
             f"{rm['fleet'].node_spec}, launches {rm['launches']} vs {rb['launches']}")
    print(json.dumps({
        "phase": "sharded_replicated", "nodes": REPLICATED_NODES, "shards": SHARDS,
        "node_spec": list(rm["fleet"].node_spec), "launches": rm["launches"],
        "meshless_launches": rb["launches"], "mesh4_s": rm["dt"], "meshless_s": rb["dt"],
        "identical_to_meshless": True,
    }), flush=True)
    del io_nodes, io_ring, rep_ring, rm, rb

    # (d) the Executive, the trace-JIT, auto and obs on the four shards
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        em = executive_run(torch, cfg, dev, exec_ring, "cuda", "vector", tmp,
                           mesh=meshes["mesh4"])
        eb = executive_run(torch, cfg, dev, exec_ring, "cuda", "vector", tmp)
    bad = same_run(check, em, eb)
    if bad or exec_stats(em) != exec_stats(eb) or em["ckpt"] != eb["ckpt"] \
            or em["fleet"].kernel_stats() != eb["fleet"].kernel_stats():
        fail(f"11 (d): the Executive fleet on {SHARDS} shards != meshless on {bad}")
    out["executive"] = {"rounds": em["res"].rounds, "mesh4_s": em["dt"], "meshless_s": eb["dt"],
                        "exec_slices": exec_stats(em)["exec_slices"]}
    del em, eb
    for executor in ("trace", "auto"):
        # trace_stats() right after each run: the engine's counters are shared
        rm = shard_drive(torch, kmod, firmware_ring, meshes["mesh4"], executor,
                         max_rounds=SHARD_TRACE_ROUNDS)
        tm = rm["fleet"].trace_stats()
        rb = shard_drive(torch, kmod, firmware_ring, None, executor,
                         max_rounds=SHARD_TRACE_ROUNDS)
        tb = rb["fleet"].trace_stats()
        bad = shard_diff(check, rm, rb)
        if executor == "auto" and rm["fleet"].analysis_stats() != rb["fleet"].analysis_stats():
            bad.append("analysis_stats")
        for key in ("spec_steps", "guard_exits", "total_steps"):
            if tm[key] != tb[key]:
                bad.append(key)
        if bad:
            fail(f"11 (d): the firmware under {executor} on {SHARDS} shards != meshless on {bad}")
        out[executor] = {"rounds": rm["res"].rounds, "mesh4_s": rm["dt"], "meshless_s": rb["dt"],
                         "spec_steps": tm["spec_steps"],
                         "plan": ([rm["fleet"]._analysis.executor, rm["fleet"]._analysis.elide_checks]
                                  if executor == "auto" else None)}
        del rm, rb
    obs_cfg = ObsConfig(trace=True, deadline_ms=OBS_DEADLINE_MS, time_rounds=True)
    rm = shard_drive(torch, kmod, ring, meshes["mesh4"], obs=obs_cfg)
    rb = shard_drive(torch, kmod, ring, None, obs=obs_cfg)
    mm, mb = rm["fleet"].metrics().as_dict(), rb["fleet"].metrics().as_dict()
    lat = mm.pop("latency"), mb.pop("latency")
    bad = shard_diff(check, rm, rb)
    if bad or mm != mb:
        fail(f"11 (d): the observed ring on {SHARDS} shards != meshless on {bad}, metrics equal "
             f"{mm == mb}")
    out["obs"] = {"rounds": rm["res"].rounds, "mesh4_s": rm["dt"], "meshless_s": rb["dt"],
                  "round_p50_ms": [x["p50_ms"] for x in lat],
                  "instructions": mm["counters"]["instructions"]}
    del rm, rb
    print(json.dumps({"phase": "sharded_engines", "nodes": n_nodes, "shards": SHARDS, **out,
                      "identical_to_meshless": True}), flush=True)

    # (e) the serve monitor on the four shards
    mons = {"mesh4": FleetServeMonitor(n=MONITOR_NODES, executor="cuda", mesh=meshes["mesh4"]),
            "meshless": FleetServeMonitor(n=MONITOR_NODES, executor="cuda", device=dev)}
    step_ms = {k: [] for k in mons}
    for step in range(1, MONITOR_STEPS + 1):
        stats = ServeStats(steps=step, prefill_tokens=SERVE_BATCH * PROMPT_LEN,
                           decode_tokens=SERVE_BATCH * step)
        for name, mon in mons.items():
            step_ms[name].append(timed(torch, lambda mon=mon: mon(stats))[1])
    ma, mb = (m.metrics().as_dict() for m in mons.values())
    ma.pop("latency")
    mb.pop("latency")
    if mons["mesh4"].reports() != mons["meshless"].reports() or ma != mb \
            or mons["mesh4"].fleet.node_spec != ("node",):
        fail("11 (e): the monitor on the mesh reports or counts otherwise than meshless")
    launches = kmod.vmloop_call.launches
    if launches <= 0:
        fail("phase 11 launched the vmloop kernel no time")
    print(json.dumps({
        "phase": "sharded_monitor", "nodes": MONITOR_NODES, "shards": SHARDS,
        "steps": MONITOR_STEPS, "step_ms": step_ms, "reports_equal_meshless": True,
        "phase_s": time.perf_counter() - t_phase, "vmloop_launches": launches,
    }), flush=True)
    return launches


def time_trace_tail(torch, kmod, check, tail, cfg) -> dict:
    """Phase 5: vmloop at the trace tail's per-node budgets (round 0 of 4g's
    fleet, after its specialized steps) in turns with the default instance
    at cfg.steps_per_slice on the same state: ms per launch (CUDA events,
    20 launches after 2 warm-ups, the state restored and a spin kernel
    queued before each), the plain version's ms, held equal, and the bound:
    the cells the launch changed, written once, and each retired
    instruction's cell, read once; or its instructions at the INT32 rate."""
    core0, budget = tail
    tb = kmod._tables(None, core0.pc.device)[0]
    work = type(core0)(*[x.clone() for x in core0])
    kinds = {"tail": {"budget": budget}, "default": {}}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = dict.fromkeys(kinds, 0.0)
    reps = 20
    outs = {}
    for rep in range(reps + 2):
        for kind, kw in kinds.items():
            for a, b in zip(work, core0):
                a.copy_(b)
            torch.cuda._sleep(SPIN_CYCLES // 100)
            start.record()
            out = kmod.vmloop_call(work, cfg.steps_per_slice if kind == "default" else 0, cfg, **kw)
            end.record()
            torch.cuda.synchronize()
            if rep >= 2:
                total[kind] += start.elapsed_time(end)
            outs[kind] = (type(core0)(*[x.clone() for x in work]), out[1:])
    final, kout = outs["tail"]
    plain = type(core0)(*[x.clone() for x in core0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    pout = kmod.run_core(plain, tb, 0, cfg, budget=budget)[1:]
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    bad = [f for f, a, b in zip(core0._fields, final, plain) if not torch.equal(a, b)]
    if bad or not all(torch.equal(a, b) for a, b in zip(kout, pout)):
        fail(f"phase 5: vmloop at the trace tail's budgets != plain version on {bad}")
    changed = sum(int((a != b).sum()) for a, b in zip(final, core0))
    instrs = int(kout[0].sum())
    nbytes = 4 * (changed + instrs)
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * instrs / INT32_OPS_PER_S
    ms = total["tail"] / reps
    rec = {"nodes": int(budget.shape[0]), "instance": "default", "budget": "trace tail",
           "budgets": [int(budget.min()), int(budget.max())], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "instructions": instrs, "bytes": nbytes, "default_ms": total["default"] / reps,
           "ms_over_default": ms / (total["default"] / reps)}
    print(f"vmloop timing n={rec['nodes']} at the trace tail's budgets {rec['budgets']}: "
          f"{ms:.4f} ms/launch (default at {cfg.steps_per_slice} in turns {rec['default_ms']:.4f}), "
          f"plain {plain_ms:.2f} ms, {instrs} instructions, bound {rec['bound_ms']:.6f} ms",
          flush=True)
    return rec


def oracle_ring(torch, dev, check, VMConfig, REXAVM, FleetVM, vms) -> None:
    """Phase 4d (a): the ANN ring at ORACLE_NODES nodes under
    executor="oracle" (each node's slice through the plain-Python Oracle on
    the host), byte for byte against executor="cuda", with each one's wall
    time.  The ring divides nothing by INT_MIN, where the Oracle's `/` and
    `mod` differ from the interpreter's."""
    cfg = VMConfig()
    n = ORACLE_NODES
    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n)]
    for i, vm in enumerate(nodes):
        vm.launch(vm.load(ann_program(i, n)))
    init = [vms.clone(vm.state) for vm in nodes]
    out = {}
    for executor in ("oracle", "cuda"):
        for vm, st in zip(nodes, init):
            vm.state = vms.clone(st)
        fleet = FleetVM(nodes=nodes, executor=executor, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fleet.run(max_rounds=200)
        out[executor] = (res, time.perf_counter() - t, vms.stack_states([vm.state for vm in nodes]))
    (ro, dto, So), (rc, dtc, Sc) = out["oracle"], out["cuda"]
    err, bad = check.max_abs_diff(So, Sc)
    if bad or ro.outputs != rc.outputs or ro.rounds != rc.rounds or ro.statuses != ["halt"] * n:
        fail(f"oracle fleet != cuda fleet on {bad} (max abs err {err}), rounds {ro.rounds} / {rc.rounds}")
    steps = int(ro.steps.sum())
    print(json.dumps({"phase": "oracle_fleet", "nodes": n, "rounds": ro.rounds, "steps": steps,
                      "oracle_s": dto, "oracle_steps_per_s": steps / dto, "cuda_s": dtc,
                      "identical_to_cuda": True}), flush=True)


def ensemble_vote(torch, dev, check, cfg, REXAVM, vms) -> None:
    """Phase 4d (b): an EnsembleVM of ENSEMBLE replicas of one ANN node on
    the card (executor="cuda"); after the first slice one replica's loop
    counter gets a bit flipped.  The vote must flag exactly that replica,
    and the healed state must agree."""
    from repro_torch.core.vm import EnsembleVM

    prog = ("array x { 10 20 30 40 } array w { 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 } "
            "array y { 0 0 0 0 } var acc "
            f"0 begin 1+ x w y 0 vecfold x y dotprod acc +! dup {ITERS} >= until drop acc @ . halt")
    vm = REXAVM(cfg, device=dev)
    vm.launch(vm.load(prog))
    ens = EnsembleVM(cfg, n=ENSEMBLE, executor="cuda", device=dev)
    S = ens.run_slice(ens.replicate(vm.state))
    bad = ENSEMBLE // 2
    S.ds[bad, 0, 0] ^= 1 << 12                 # the loop counter, mid-loop
    for _ in range(8):
        S = ens.run_slice(S)
    vote = ens.vote(S)
    if vote.faulty != [bad] or vote.agree:
        fail(f"ensemble: the vote flagged {vote.faulty}, expected [{bad}]")
    healed = ens.heal(S, vote)
    if not ens.vote(healed).agree or check.max_abs_diff(
            vms.take_nodes(healed, [bad]), vms.take_nodes(S, [0]))[1]:
        fail("ensemble: the healed replica does not equal the majority")
    print(json.dumps({"phase": "ensemble", "replicas": ENSEMBLE, "executor": "cuda",
                      "flipped": bad, "faulty": vote.faulty, "healed_agree": True}), flush=True)


def monitor_obs(torch, kmod, dev, FleetServeMonitor, ServeStats, ObsConfig) -> int:
    """The serve monitor with obs (64 nodes, executor="cuda"), driven as an
    engine drives it for three steps: returns the counting instance's
    launches, after checking that it reported and counted."""
    mon = FleetServeMonitor(n=MONITOR_NODES, executor="cuda", device=dev,
                            obs=ObsConfig(time_rounds=True))
    kmod.vmloop_call.obs_launches = 0
    for step in range(1, 4):
        mon(ServeStats(steps=step, prefill_tokens=SERVE_BATCH * PROMPT_LEN,
                       decode_tokens=SERVE_BATCH * step))
    launches = kmod.vmloop_call.obs_launches
    c = mon.metrics().as_dict()["counters"]
    if launches <= 0 or c["instructions"] <= 0 or mon.reports() != [[SERVE_BATCH] * 3] * MONITOR_NODES:
        fail(f"monitor with obs: {launches} counting launches, {c['instructions']} instructions")
    print(f"monitor obs: {launches} counting launches, {c['instructions']} instructions binned "
          f"over {c['rounds_observed']} rounds", flush=True)
    return launches


def time_vmloop(torch, kmod, nodes, states, cfg, dev, elided: bool = False,
                quantum: bool = False) -> tuple:
    """One slice (cfg.steps_per_slice) of vmloop over the stacked ``states``
    of ``nodes``, scheduled as the executor does, for the default instance,
    the counting one (obs=True), with ``elided`` the checks-elided one
    (elide_checks=True) and with ``quantum`` the default instance at the
    Executive's budget of 32, in turns: ms per launch (CUDA events around
    each of 20 launches after 2 warm-ups, the state restored and a spin
    kernel queued before each, so the events time the device), each plain
    version's ms, held equal (the counting instance's op_hist too; the
    checks-elided instance on verified programs also equal to the default),
    and the bound: the cells the launch changed (each written once) plus
    each node's loaded code frame (its program and arrays, each read once)
    and, for the counting instance, its op_hist written once; or its
    instructions at the INT32 rate.  Returns the records in the order
    default, counting[, checks-elided][, budget 32]."""
    from repro_torch.core.vm import vmstate as vms
    from repro_torch.core.vm.interp import interp_for
    from repro_torch.kernels.vmloop import check
    from repro_torch.kernels.vmloop.ref import core_of, vmloop_ref

    kwargs = {"default": {}, "counting": {"obs": True}, "checks-elided": {"elide_checks": True},
              "budget 32": {}}
    budgets = dict.fromkeys(kwargs, cfg.steps_per_slice)
    budgets["budget 32"] = 32
    # the default instance last in each turn: `work` keeps its state
    order = (("counting",) + (("checks-elided",) if elided else ())
             + (("budget 32",) if quantum else ()) + ("default",))
    S0 = vms.to_device(vms.stack_states(states), dev)
    interp_for(cfg).schedule(S0)
    work = vms.clone(S0)
    core = core_of(work)
    reps = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = dict.fromkeys(order, 0.0)
    finals = {}
    for rep in range(reps + 2):                 # two warm-up launches
        for inst in order:
            for a, b in zip(work, S0):
                a.copy_(b)
            torch.cuda._sleep(SPIN_CYCLES // 100)   # the launch is queued before the events run
            start.record()
            out = kmod.vmloop_call(core, budgets[inst], cfg, **kwargs[inst])
            end.record()
            torch.cuda.synchronize()
            if rep >= 2:
                total[inst] += start.elapsed_time(end)
            finals[inst] = (work if inst == "default" else vms.clone(work), out[1:])
    n = len(nodes)
    frame_cells = sum(sum(f.end - f.start for f in vm.frames.frames.values()) for vm in nodes)
    recs = []
    for inst in ("default",) + order[:-1]:
        final, outs = finals[inst]
        changed = sum(int((a != b).sum()) for a, b in zip(final, S0))
        n_exec = outs[0]
        instrs = int(n_exec.sum())
        longest = int(n_exec.max())
        plain = vms.clone(S0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain_out = vmloop_ref(plain, budgets[inst], cfg, **kwargs[inst])[1:]
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t)
        err, bad = check.max_abs_diff(final, plain)
        if not all(torch.equal(a, b) for a, b in zip(outs, plain_out)):
            bad.append("n_exec/bailed/bail_op" + ("/op_hist" if inst == "counting" else ""))
        if bad:
            fail(f"timed launch (n={n}, {inst} instance) != plain version on {bad}")
        if inst == "checks-elided" and (check.max_abs_diff(final, work)[1] or not all(
                torch.equal(a, b) for a, b in zip(outs, finals["default"][1]))):
            fail(f"timed launch (n={n}): the checks-elided instance != the default one")
        nbytes = 4 * (changed + frame_cells + (n * (kmod.NUM_OPS + 4) if inst == "counting" else 0))
        ms = total[inst] / reps
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * instrs / INT32_OPS_PER_S
        label = {"default": "", "budget 32": " at budget 32"}.get(inst, f" {inst} instance")
        print(f"vmloop timing n={n}{label}: {ms:.4f} ms/launch, "
              f"plain {plain_ms:.2f} ms, {instrs} instructions, longest node {longest} "
              f"({1e6 * ms / longest:.1f} ns each), bound {max(t_bytes, t_ops):.6f} ms ({nbytes} B)",
              flush=True)
        recs.append({"nodes": n, "instance": inst, "budget": budgets[inst], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "instructions": instrs, "longest_node": longest,
                     "ns_per_instruction": 1e6 * ms / longest, "bytes": nbytes})
    for rec in recs[1:]:
        rec["ms_over_default"] = rec["ms"] / recs[0]["ms"]
    return tuple(recs)


def danube_gemms():
    """(K, N, launches per decode step) of the quantized danube projections:
    per layer wq, wk, wv, wo, w1, w3, w2; then lm_head."""
    from repro_torch.config import get_arch

    c = get_arch(ARCH)
    L, d = c.num_layers, c.d_model
    return [(d, c.q_dim, L), (d, c.kv_dim, 2 * L), (c.q_dim, d, L), (d, c.d_ff, 2 * L),
            (c.d_ff, d, L), (d, c.padded_vocab, 1)]


def new_arch_gemms():
    """(K, N) of every quantized projection of the configs of phases 7g,
    7h and 7i, each once: what their decode steps give fixmatmul at M 8
    (whisper's cross attention has its self attention's shapes)."""
    from repro_torch.config import get_arch

    shapes = set()
    for arch in (MOE_ARCH,) + tuple(a for a, _ in OTHER_ARCHS) + FAMILY_ARCHS:
        c = get_arch(arch)
        shapes |= {(c.d_model, c.q_dim), (c.d_model, c.kv_dim), (c.q_dim, c.d_model),
                   (c.d_model, c.padded_vocab)}
        if c.family != "moe":
            shapes |= {(c.d_model, c.d_ff), (c.d_ff, c.d_model)}
    return sorted(shapes)


def moe_gemms():
    """(K, N, launches per decode step) of qwen2-moe's quantized
    projections: wq, wk, wv, wo (all 2048 x 2048) per layer; lm_head."""
    from repro_torch.config import get_arch

    c = get_arch(MOE_ARCH)
    return [(c.d_model, c.q_dim, 4 * c.num_layers), (c.d_model, c.padded_vocab, 1)]


def lm_head(arch):
    """(K, N) of ``arch``'s quantized lm_head (rwkv6-7b's is its one
    fixmatmul a decode step)."""
    from repro_torch.config import get_arch

    c = get_arch(arch)
    return c.d_model, c.padded_vocab


def fix_operands(torch, M, K, N, dev, g, code=None, offset=0):
    """Random int8 codes (or all ``code``) and scales; xq and wq start
    ``offset`` bytes into larger buffers, so offset 1 misaligns them."""
    ops = []
    for n in (M * K, K * N):
        if code is None:
            buf = torch.randint(-128, 128, (n + offset,), generator=g, device=dev).to(torch.int8)
        else:
            buf = torch.full((n + offset,), code, dtype=torch.int8, device=dev)
        ops.append(buf[offset:])
    xq, wq = ops[0].view(M, K), ops[1].view(K, N)
    sx = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3
    sw = torch.rand(N, generator=g, device=dev) * 0.05 + 1e-3
    return xq, wq, sx, sw


def check_fixmatmul(torch, fix_mod, dev) -> float:
    """Bitwise against the plain version: danube's decode shapes at M 1 to
    64 (the streaming kernel at M <= 16, the tiled one above), rwkv6's
    lm_head, ragged N and K, xq and wq misaligned by one byte, and
    extreme codes at K = 6912."""
    from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref
    from repro_torch.kernels.nvcc import sm_count

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(M, K, N, None, 0) for M in (1, 2, 4, 8, 16, 17, 64) for K, N, _ in danube_gemms()]
    cases += [(SERVE_BATCH, *lm_head(RWKV_ARCH), None, 0)]
    cases += [(SERVE_BATCH, K, N, None, 0) for K, N in new_arch_gemms()]
    cases += [(M, K, N, None, 0) for M in (3, 16) for K, N in ((100, 37), (2560, 641), (6913, 640))]
    cases += [(65, 257, 129, None, 0), (1, 1, 1, None, 0), (17, 6912, 2560, None, 0)]
    cases += [(M, K, N, None, 1) for M, K, N in ((8, 2560, 640), (16, 6912, 2560), (3, 100, 37),
                                                 (65, 257, 129))]
    cases += [(M, 6912, 640, code, 0) for M in (1, 8, 16) for code in (-128, 127)]
    cases += [(64, 6912, 2560, -128, 0)]
    kinds = set()
    for M, K, N, code, offset in cases:
        ops = fix_operands(torch, M, K, N, dev, g, code, offset)
        out, ref = fix_mod.fixmatmul(*ops), fixmatmul_ref(*ops)
        torch.cuda.synchronize()
        kinds.add(fix_mod.plan(M, K, N, sm_count(dev)).kernel)
        if not torch.equal(out, ref):
            err = float((out - ref).abs().max())
            fail(f"fixmatmul (M, K, N) = {(M, K, N)}, codes {code}, offset {offset}: kernel != "
                 f"plain version, max abs err {err}")
        del ops, out, ref
    if kinds != {"stream", "tiled"}:
        fail(f"check fixmatmul reached only the {kinds} kernel(s)")
    print(f"check fixmatmul: {len(cases)} shapes (danube decode at M = 1/2/4/8/16/17/64, rwkv6 "
          f"lm_head and the decode shapes of qwen2-moe, qwen3-moe, starcoder2, glm4, granite, "
          f"zamba2, whisper and internvl2 at M = 8, ragged, misaligned by a byte, extreme "
          f"codes at K = 6912; both kernels): bitwise equal", flush=True)
    return 0.0


def check_flash(torch, flash_mod, dev) -> float:
    """Returns the largest error in bf16, the main path's type.  Every
    bf16 case must launch the tensor-core kernel, every f32 case the FP32
    one."""
    from repro_torch.kernels.flashattn.ref import flash_attention_ref

    fa = flash_mod.flash_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = [  # (B, H, KV, Sq, Sk, hd, causal, window, layout)
        (1, 32, 8, 512, 512, 80, True, 4096, "bhsd"),
        (1, 32, 8, 700, 700, 80, True, 8, "bhsd"),
        (2, 8, 8, 200, 200, 64, True, None, "bhsd"),
        (1, 8, 2, 100, 333, 128, False, None, "bhsd"),      # non-causal ragged Sk
        (2, 4, 1, 129, 129, 80, False, 8, "bhsd"),
        (1, 4, 4, 65, 193, 64, False, 4096, "bhsd"),
        (1, 8, 2, 300, 300, 128, True, 100, "bhsd"),
        (1, 4, 2, 130, 130, 16, True, None, "bhsd"),        # hd 16 (SMOKE), ragged Sq
        (1, 8, 2, 200, 200, 72, True, 100, "bhsd"),         # hd 72: zeroed columns 72..80
        (1, 4, 1, 150, 150, 36, True, 70, "bhsd"),          # hd 36: the padded copy
        (2, 8, 2, 333, 333, 80, True, 200, "bhsd"),         # B 2, GQA 4, window % 64 != 0
        (2, 8, 2, 257, 257, 80, True, 100, "bshd"),         # ops.attention's view
        (1, 8, 2, 200, 200, 80, True, None, "stride84"),    # no 16-byte row copies
        (1, 16, 16, PREFILL_LEN, PREFILL_LEN, 128, True, None, "bhsd"),  # qwen2-moe prefill: G 1
        (1, 36, 4, 1000, 1000, 128, True, None, "bhsd"),    # G 9 (starcoder2-7b)
        (1, 48, 1, 777, 777, 128, True, None, "bhsd"),      # G 48, MQA (granite-34b)
    ]
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        tol = FLASH_TOL[str(dt).split(".")[1]]
        errs = []
        for B, H, KV, Sq, Sk, hd, causal, window, layout in cases:
            if layout == "bshd":
                q, k, v = (torch.randn(sh, generator=g, device=dev).to(dt).movedim(1, 2)
                           for sh in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
            else:
                w = 84 if layout == "stride84" else hd
                q, k, v = (torch.randn(sh, generator=g, device=dev).to(dt)[..., :hd]
                           for sh in ((B, H, Sq, w), (B, KV, Sk, w), (B, KV, Sk, w)))
            n, tc = fa.launches, fa.tc_launches
            out = fa(q, k, v, causal=causal, window=window)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if (fa.launches, fa.tc_launches) != (n + 1, tc + (dt == torch.bfloat16)):
                fail(f"flash attention {dt} {(B, H, KV, Sq, Sk, hd, causal, window, layout)}: "
                     f"launched {fa.launches - n} kernels, {fa.tc_launches - tc} on the tensor cores")
            err = float((out.float() - ref.float()).abs().max())
            if not (out.dtype == dt and out.shape == q.shape and err <= tol):
                fail(f"flash attention {dt} {(B, H, KV, Sq, Sk, hd, causal, window, layout)}: "
                     f"max abs err {err} > {tol}")
            errs.append(err)
        worst[dt] = max(errs)
        print(f"check flash attention {dt}: {len(cases)} shapes, max abs err {max(errs):.3g} "
              f"(tolerance {tol})", flush=True)
    return worst[torch.bfloat16]


def rwkv6_inputs(torch, B, H, S, K, dt, dev, g, decay="slow"):
    """r, k, v (dt), logw, u, state0 of the JAX kernel tests' distributions.
    ``decay="fast"`` draws log decays down to -7.4 a step, so the chunk's
    cumulative decays pass the kernel's clip at -60."""
    r, k, v = ((torch.randn((B, H, S, K), generator=g, device=dev) * 0.5).to(dt) for _ in range(3))
    lo, hi = (-6.0, -4.0) if decay == "slow" else (-1.0, 2.0)
    logw = -torch.exp(torch.rand((B, H, S, K), generator=g, device=dev) * (hi - lo) + lo)
    u = torch.randn((H, K), generator=g, device=dev) * 0.5
    s0 = torch.randn((B, H, K, K), generator=g, device=dev) * 0.1
    return r, k, v, logw, u, s0


def rwkv6_rel(out, s1, ref, ref_s1) -> tuple:
    """(out, state) max abs errors, each relative to max(1, max |ref|)."""
    return (float((out.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max())),
            float((s1 - ref_s1).abs().max()) / max(1.0, float(ref_s1.abs().max())))


def check_rwkv6_scan(torch, rwkv_mod, dev) -> float:
    """Returns the largest absolute error of ``out`` in bf16, the main
    path's type.  Errors are held relative to max(1, max |plain|)."""
    from repro_torch.kernels.rwkv6_scan.ref import decode_ref, rwkv6_scan_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases = [  # (B, H, S, K, chunk, decay)
        (1, 64, 512, 64, 64, "slow"),      # L 64, eight chunks, the full model's heads
        (2, 3, 192, 36, 64, "slow"),       # K 36: rows of no 16-byte multiple, plain loads
        (2, 8, 256, 64, 32, "slow"),       # L 32
        (2, 4, 128, 16, 16, "slow"),       # L 16, the SMOKE head size
        (8, 64, 1, 64, 64, "slow"),        # S 1: the decode step's shape
        (8, 64, 1, 64, 64, "fast"),
        (1, 3, 1, 36, 64, "slow"),         # S 1 at a ragged head count and K 36
        (2, 4, 16, 16, 1, "slow"),         # L 1 over sixteen chunks
        (1, 4, 40, 64, 64, "slow"),        # S < 64: L = S
        (4, 4, 48, 16, 64, "slow"),
        (1, 8, 256, 64, 64, "fast"),       # the clip at -60 active
    ]
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        tol = RWKV_TOL[str(dt).split(".")[1]]
        errs, rels, two_pass, one_step = [], [], 0, 0
        for B, H, S, K, chunk, decay in cases:
            r, k, v, logw, u, s0 = rwkv6_inputs(torch, B, H, S, K, dt, dev, g, decay)
            before = (rwkv_mod.rwkv6_scan.chunked_launches, rwkv_mod.rwkv6_scan.decode_launches)
            kernel = rwkv_mod.route(S, chunk)
            chunked, decode = kernel == "chunked", kernel == "decode"
            out, s1 = rwkv_mod.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk)
            ref, ref_s1 = rwkv6_scan_ref(r, k, v, logw, u, s0, chunk=chunk)
            s_in = s0.clone()
            out2, s2 = rwkv_mod.rwkv6_scan(r, k, v, logw, u, s_in, chunk=chunk, state_out=s_in)
            after = (rwkv_mod.rwkv6_scan.chunked_launches, rwkv_mod.rwkv6_scan.decode_launches)
            if decode:      # against its closed form and the one-block kernel
                for name, (want, want_s1) in (
                        ("decode_ref", decode_ref(r, k, v, logw, u, s0)),
                        ("the one-block kernel", rwkv_mod.rwkv6_scan(r, k, v, logw, u, s0,
                                                                     kernel="one_block"))):
                    o_rel, st_rel = rwkv6_rel(out, s1, want, want_s1)
                    if o_rel > tol or st_rel > RWKV_STATE_TOL:
                        fail(f"rwkv6_scan {dt} {(B, H, S, K, decay)}: the decode kernel against "
                             f"{name}: out {o_rel}, state {st_rel}")
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            s_err = float((s1 - ref_s1).abs().max())
            rel = err / max(1.0, float(ref.abs().max()))
            s_rel = s_err / max(1.0, float(ref_s1.abs().max()))
            if not (out.dtype == dt and rel <= tol and s_rel <= RWKV_STATE_TOL
                    and bool(torch.isfinite(out).all())):
                fail(f"rwkv6_scan {dt} {(B, H, S, K, chunk, decay)}: out err {err} ({rel} of the "
                     f"largest, tolerance {tol}), state err {s_err} ({s_rel}, tolerance "
                     f"{RWKV_STATE_TOL})")
            if not (s2 is s_in and torch.equal(out2, out) and torch.equal(s_in, s1)):
                fail(f"rwkv6_scan {dt} {(B, H, S, K, chunk)}: the state written in place differs")
            if after != (before[0] + 2 * chunked, before[1] + 2 * decode):
                fail(f"rwkv6_scan {dt} {(B, H, S, K, chunk)}: took the wrong route (chunked, "
                     f"decode launches {before} -> {after}, route {kernel})")
            two_pass += chunked
            one_step += decode
            errs.append(err)
            rels.append((rel, s_rel))
        # chained halves: the state carried across two calls == one call
        r, k, v, logw, u, s0 = rwkv6_inputs(torch, 1, 8, 256, 64, dt, dev, g)
        full, s_full = rwkv_mod.rwkv6_scan(r, k, v, logw, u, s0)
        h1, s_mid = rwkv_mod.rwkv6_scan(r[:, :, :128], k[:, :, :128], v[:, :, :128],
                                        logw[:, :, :128], u, s0)
        h2, s_end = rwkv_mod.rwkv6_scan(r[:, :, 128:], k[:, :, 128:], v[:, :, 128:],
                                        logw[:, :, 128:], u, s_mid)
        torch.cuda.synchronize()
        c_err = float((torch.cat([h1, h2], 2).float() - full.float()).abs().max())
        c_s = float((s_end - s_full).abs().max())
        if c_err > tol * max(1.0, float(full.float().abs().max())) or \
                c_s > RWKV_STATE_TOL * max(1.0, float(s_full.abs().max())):
            fail(f"rwkv6_scan {dt}: chained halves differ from the whole: out {c_err}, state {c_s}")
        chain = decode_chain(torch, rwkv_mod, dt, dev, g)
        if chain[0] > tol or chain[1] > RWKV_STATE_TOL:
            fail(f"rwkv6_scan {dt}: four decode steps in place against four plain steps: out "
                 f"{chain[0]}, state {chain[1]}")
        worst[dt] = max(errs)
        print(f"check rwkv6_scan {dt}: {len(cases)} shapes ({two_pass} on the two passes, "
              f"{one_step} on the decode kernel) + chained halves, out max abs err "
              f"{max(errs):.3g} (largest relative {max(x for x, _ in rels):.3g}, tolerance {tol}), "
              f"state relative {max(y for _, y in rels):.3g} (tolerance {RWKV_STATE_TOL}); "
              f"chained: out {c_err:.3g}, state {c_s:.3g}; state written in place: equal; "
              f"4 decode steps in place at B 8 H 64: out {chain[0]:.3g}, state {chain[1]:.3g} "
              f"relative", flush=True)
    return worst[torch.bfloat16]


def decode_chain(torch, rwkv_mod, dt, dev, g, steps: int = 4) -> tuple:
    """``steps`` decode steps in place on one B 8 x H 64 x K 64 state, back
    to back on the stream (each launch reads the state the one before it
    writes), against as many plain steps: the largest relative errors of
    any step's out and of the last state."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    ins = [rwkv6_inputs(torch, SERVE_BATCH, 64, 1, 64, dt, dev, g) for _ in range(steps)]
    u, state = ins[0][4], ins[0][5]
    ref_state = state.clone()
    before = rwkv_mod.rwkv6_scan.decode_launches
    outs = [rwkv_mod.rwkv6_scan(r, k, v, logw, u, state, state_out=state)[0]
            for r, k, v, logw, _, _ in ins]
    torch.cuda.synchronize()
    if rwkv_mod.rwkv6_scan.decode_launches != before + steps:
        fail(f"rwkv6_scan: {steps} decode steps in place launched the decode kernel "
             f"{rwkv_mod.rwkv6_scan.decode_launches - before} times")
    worst = 0.0
    for out, (r, k, v, logw, _, _) in zip(outs, ins):
        ref, ref_state = rwkv6_scan_ref(r, k, v, logw, u, ref_state)
        worst = max(worst, rwkv6_rel(out, ref_state, ref, ref_state)[0])
    return worst, rwkv6_rel(outs[-1], state, ref, ref_state)[1]


def check_lut_sigmoid(torch, lut_mod, dev) -> None:
    from repro_torch.kernels.lutact.ref import lut_sigmoid_ref

    i32 = torch.iinfo(torch.int32)
    edges = [i32.min, i32.min + 1, i32.max, i32.max - 1, 0, 1, -1]
    edges += [sgn * x for sgn in (1, -1) for x in (7999, 8000, 8001)]
    edges += [m + d for m in range(-8250, 8251, 250) for d in (-1, 0, 1)]
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    rnd = torch.randint(i32.min, i32.max, (1 << 24,), generator=g, device=dev, dtype=torch.int32)
    x = torch.cat([torch.tensor(edges, dtype=torch.int32, device=dev), rnd])
    shapes = [x, x[1:], x[: 3 * 5 * 4096].reshape(3, 5, 4096), x[: 7 << 20].reshape(-1, 7)[:, 2]]
    for xs in shapes:
        out = lut_mod.lut_sigmoid(xs)
        ref = lut_sigmoid_ref(xs)
        torch.cuda.synchronize()
        if not (out.shape == xs.shape and out.dtype == torch.int32 and torch.equal(out, ref)):
            bad = (out != ref).nonzero()[:4].flatten().tolist() if out.shape == ref.shape else []
            fail(f"lut_sigmoid {tuple(xs.shape)}: kernel != plain version at {bad}")
    print(f"check lut_sigmoid: {len(edges)} edge values (INT_MIN, INT_MAX, +-7999/8000/8001, "
          f"every multiple of 250 in +-8250 and its neighbours) + 2**24 random int32, as 1-D, "
          f"unaligned 1-D, 3-D and strided inputs: byte-identical", flush=True)


class StepClock:
    """The model as the engine sees it, with a synchronized host clock
    around each decode step."""

    def __init__(self, torch, model):
        self._torch, self._model, self.ms = torch, model, []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *args):
        self._torch.cuda.synchronize()
        t = time.perf_counter()
        out = self._model.decode_step(*args)
        self._torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t))
        return out


class TimedMonitor:
    def __init__(self, torch, monitor):
        self._torch, self.monitor, self.ms = torch, monitor, []

    def __call__(self, stats):
        self._torch.cuda.synchronize()
        t = time.perf_counter()
        self.monitor(stats)
        self._torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t))


def build_full(torch, arch, dev, layers=None, kv_cache_dtype="auto"):
    """The arch's full config (cut to ``layers`` when given), model and
    random params drawn on the card."""
    from repro_torch.config import get_arch
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_flatten_with_names

    full = get_arch(arch)
    cfg = full.replace(num_layers=layers or full.num_layers, kv_cache_dtype=kv_cache_dtype)
    model = build_model(cfg, dev)
    t = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in tree_flatten_with_names(params))
    print(f"serve: {arch} {cfg.num_layers} of {full.num_layers} layers d {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params in {cfg.dtype}, KV cache {kv_cache_dtype}, drawn on "
          f"the card in {time.perf_counter() - t:.2f} s", flush=True)
    return cfg, model, params


def prefill_tokens(torch, cfg, dev, seq=PREFILL_LEN):
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    return torch.randint(0, cfg.vocab_size, (1, seq), generator=g, device=dev)


def prefill(torch, model, params, cfg, dev, kernel, plain: dict, extra: dict,
            plain_alt: list | None = None, counters: tuple = ("launches",),
            seq: int = PREFILL_LEN, batch: dict | None = None,
            expected: int | None = None) -> int:
    """(a) Model.forward at B 1, S ``seq`` through ``kernel`` (one
    launch per layer), timed after a warm-up at 1024 tokens and again at
    the same length (then the allocator and the libraries have met every
    shape), held against the same forward with ``plain`` (the
    forward's hook, e.g. ``{"attention": blocked_attention}``): the logits
    may differ by PREFILL_REL_TOL of the largest.  When ``plain_alt`` (a
    list of hooks: the plain version with its sums in other orders) is
    given, the kernel's mean |logit difference| may
    instead be up to ALT_MEAN_TOL times the most a reordering alone moves
    it, and its argmax agreement at most ALT_AGREE_TOL below the least
    of the reorderings'.  Each of the kernel's
    ``counters`` (``launches``, and per route where it has one) must count
    ``expected`` launches (default: one per layer).  ``batch`` replaces
    the B 1 x ``seq`` random tokens (with a ``frontend`` for the encdec
    and vlm families; the warm-up keeps its first 1024 tokens).  The
    forward's aux loss (the MoE layers' load balance) is printed.  Returns
    the kernel's launches."""
    batch = batch or {"tokens": prefill_tokens(torch, cfg, dev, seq)}
    expected = cfg.num_layers if expected is None else expected
    B, seq = batch["tokens"].shape
    positions = B * (seq + (batch["frontend"].shape[1] if "frontend" in batch else 0))
    model.forward(params, {**batch, "tokens": batch["tokens"][:, :1024]})     # warm-up
    for c in counters:
        setattr(kernel, c, 0)
    (logits, aux), prefill_ms = timed(torch, lambda: model.forward(params, batch))
    counts = {f"{kernel.__name__}_{c}": getattr(kernel, c) for c in counters}
    launches = kernel.launches
    for name, n in counts.items():
        if n != expected:
            fail(f"{cfg.name} prefill: {name} = {n}, not {expected}")
    _, again_ms = timed(torch, lambda: model.forward(params, batch))
    (ref, _), plain_ms = timed(torch, lambda: model.forward(params, batch, **plain))
    if logits.shape != (B, seq, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"{cfg.name} prefill logits: shape {tuple(logits.shape)}, "
             f"finite {bool(torch.isfinite(logits).all())}")
    def compare(a):
        d = (a.float() - ref.float()).abs()
        return (float(d.max()), int(d.amax(-1).argmax()), float(d.mean()),
                float((a.argmax(-1) == ref.argmax(-1)).float().mean()))

    diff, at, mean, agree = compare(logits)
    scale = float(ref.float().abs().max())
    res = {"aux_loss": float(aux), "max_abs_logit_diff": diff, "at_position": at,
           "mean_abs_logit_diff": mean,
           "max_abs_logit": scale, "mean_abs_logit": float(ref.float().abs().mean()),
           "argmax_agreement": agree}
    if plain_alt is None:
        res["tolerance"] = PREFILL_REL_TOL * scale
        ok = diff <= res["tolerance"]
    else:
        del logits
        alts = []
        for alt in plain_alt:
            alt_logits, _ = model.forward(params, batch, **alt)
            alts.append(compare(alt_logits))
            del alt_logits
        a_diff, a_at, a_mean, a_agree = ([a[i] for a in alts] for i in range(4))
        res |= {"reordered_max_abs_logit_diff": a_diff, "reordered_at_position": a_at,
                "reordered_mean_abs_logit_diff": a_mean, "reordered_argmax_agreement": a_agree,
                "tolerance_mean": ALT_MEAN_TOL * max(a_mean),
                "tolerance_agreement": min(a_agree) - ALT_AGREE_TOL}
        ok = mean <= res["tolerance_mean"] and agree >= res["tolerance_agreement"]
    print(json.dumps({"phase": "prefill", "arch": cfg.name, "layers": cfg.num_layers, "batch": B,
                      "seq": seq, "positions": positions, **extra, **counts, "ms": prefill_ms,
                      "tokens_per_s": positions / (prefill_ms / 1e3), "ms_again": again_ms,
                      "tokens_per_s_again": positions / (again_ms / 1e3),
                      f"plain_{next(iter(plain))}_ms": plain_ms, **res}), flush=True)
    print(f"serve: {cfg.name} prefill {positions / (prefill_ms / 1e3):.1f} tokens/s, again "
          f"{positions / (again_ms / 1e3):.1f} (Model.forward, B {B}, S {seq}, {positions} "
          f"positions); argmax agreement with the plain forward "
          f"{100 * agree:.2f}%", flush=True)
    if not ok:
        fail(f"{cfg.name} prefill logits: kernel vs plain {res}")
    return launches


def serve_engine(torch, model, qparams, cfg, dev, kmod, per_step: dict,
                 prompt_len: int = PROMPT_LEN, new_tokens: int = NEW_TOKENS) -> dict:
    """(b) ServeEngine over the quantized params with a 64-node
    FleetServeMonitor(executor="cuda") as on_step: 8 prompts of
    ``prompt_len`` seeded tokens, ``new_tokens`` greedy new tokens.
    ``per_step`` maps each kernel's wrapper to its launches per decode
    step, which must hold over every step.  Returns each kernel's launches
    by name."""
    from repro_torch.config import ServeConfig
    from repro_torch.serve import FleetServeMonitor, ServeEngine

    monitor = TimedMonitor(torch, FleetServeMonitor(n=MONITOR_NODES, executor="cuda", device=dev))
    clock = StepClock(torch, model)
    engine = ServeEngine(clock, qparams, ServeConfig(), max_len=prompt_len + new_tokens,
                         on_step=monitor)
    rng = torch.Generator().manual_seed(SEED + 3)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt_len), generator=rng).tolist()
    for fn in per_step:
        fn.launches = 0
    kmod.vmloop_call.launches = 0
    t = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in per_step}
    launches_vm = kmod.vmloop_call.launches
    steps = len(clock.ms)
    for fn, n in per_step.items():
        if fn.launches != n * steps:
            fail(f"{cfg.name}: {fn.__name__} launched {fn.launches} times over {steps} decode "
                 f"steps, not {n} per step")
    if launches_vm <= 0:
        fail(f"{cfg.name}: the serve monitor launched the vmloop kernel no time")
    reports = monitor.monitor.reports()
    if reports != [[SERVE_BATCH] * new_tokens] * MONITOR_NODES:
        fail(f"{cfg.name}: monitor reports {sorted({tuple(r) for r in reports})[:2]}, expected "
             f"[{SERVE_BATCH}] * {new_tokens} on each of {MONITOR_NODES} nodes")
    if [len(o) for o in outs] != [prompt_len + new_tokens] * SERVE_BATCH or not all(
            0 <= tok < cfg.vocab_size for o in outs for tok in o):
        fail(f"{cfg.name}: generated tokens: wrong count or out of the vocabulary")
    prefill_steps, decode_steps = clock.ms[:prompt_len], clock.ms[prompt_len:]
    decode_s = total_s - sum(prefill_steps) / 1e3 - sum(monitor.ms) / 1e3
    counts = {}
    for name, n in launches.items():
        counts[f"{name}_launches"] = n
        counts[f"{name}_per_step"] = n / steps
    print(json.dumps({
        "phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
        "kv_cache_dtype": cfg.kv_cache_dtype, "batch": SERVE_BATCH, "prompt_len": prompt_len,
        "new_tokens": new_tokens, "monitor_nodes": MONITOR_NODES,
        "decode_steps": steps, **counts, "vmloop_launches": launches_vm,
        "generate_s": total_s,
        "replay_prefill_tokens_per_s": SERVE_BATCH * prompt_len / (sum(prefill_steps) / 1e3),
        "decode_tokens_per_s": engine.stats.decode_tokens / decode_s,
        "ms_per_decode_step": sum(decode_steps) / len(decode_steps),
        "monitor_ms_per_step": sum(monitor.ms) / len(monitor.ms),
        "monitor_transfer": monitor.monitor.transfer_stats(),
    }), flush=True)
    print(f"serve: {cfg.name} decode {engine.stats.decode_tokens / decode_s:.1f} tokens/s "
          f"(B {SERVE_BATCH}, monitor excluded)", flush=True)
    print(f"serve: {cfg.name} {sum(decode_steps) / len(decode_steps):.3f} ms per decode step",
          flush=True)
    print(f"serve: {cfg.name} monitor {sum(monitor.ms) / len(monitor.ms):.3f} ms per step "
          f"({MONITOR_NODES} nodes, executor=cuda)", flush=True)
    return launches


def serve_danube(torch, dev, fix_mod, flash_mod, kmod):
    """Phase 7 (a)-(d).  Returns the fixmatmul and flash launches of the
    main path."""
    from repro_torch.config import get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.attention import blocked_attention
    from repro_torch.models.quantized import quantize_params
    from repro_torch.utils.tree import tree_map_with_names

    cfg, model, params = build_full(torch, ARCH, dev)

    # (a) prefill through the flash kernel, against the plain attention
    launches_flash = prefill(torch, model, params, cfg, dev, flash_mod.flash_attention,
                             {"attention": blocked_attention}, {"window": cfg.sliding_window},
                             counters=("launches", "tc_launches"))
    torch.cuda.empty_cache()

    # (b) quantize, then serve with the VM fleet as the measuring job
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    launches_fix = serve_engine(torch, model, qparams, cfg, dev, kmod,
                                {fix_mod.fixmatmul: 7 * cfg.num_layers + 1})["fixmatmul"]

    # (d) where a decode step's device time goes
    profile_decode(torch, model, qparams, cfg, dev)
    del qparams
    torch.cuda.empty_cache()

    # (c) small input, held against the CPU: the SMOKE config's quantized
    # decode steps, teacher-forced on one token sequence.  Float sums on
    # the card and the CPU differ in their last bits, which can move an
    # activation's int8 code by one step; SMOKE_TOL bounds what that does
    # to a logit.
    small = get_smoke(ARCH)
    cpu_model, gpu_model = build_model(small, "cpu"), build_model(small, dev)
    p_cpu = quantize_params(cpu_model.init(SEED))
    p_gpu = tree_map_with_names(lambda _, x: x.to(dev), p_cpu)
    toks = torch.randint(0, small.vocab_size, (3, 20), generator=torch.Generator().manual_seed(SEED))
    c_cpu, c_gpu = cpu_model.init_cache(3, 32), gpu_model.init_cache(3, 32)
    worst = 0.0
    for t in range(toks.shape[1]):
        l_cpu, c_cpu = cpu_model.decode_step(p_cpu, c_cpu, toks[:, t:t + 1])
        l_gpu, c_gpu = gpu_model.decode_step(p_gpu, c_gpu, toks[:, t:t + 1].to(dev))
        worst = max(worst, float((l_gpu.cpu() - l_cpu).abs().max()))
    if not worst <= SMOKE_TOL:
        fail(f"SMOKE quantized decode on the card vs the CPU: max abs logit diff {worst}")
    print(f"serve: SMOKE quantized decode, 3 rows x 20 steps (the window-8 cache wraps): "
          f"card vs CPU max abs logit diff {worst:.3g} (tolerance {SMOKE_TOL})", flush=True)
    return launches_fix, launches_flash


def serve_rwkv6(torch, dev, fix_mod, rwkv_mod, kmod):
    """Phase 7 (e): rwkv6-7b at full width.  Returns the rwkv6_scan
    launches by path ("prefill", "serve") and the fixmatmul launches."""
    from repro_torch.config import ServeConfig, get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.quantized import quantize_params
    from repro_torch.models.rwkv6 import chunked_wkv
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_map_with_names

    cfg, model, params = build_full(torch, RWKV_ARCH, dev)
    # bf16 rounding of each layer's wkv output, one step either way, grows
    # through 32 layers of random weights (the largest difference sits at
    # position 0, where a head's output is the bonus term alone): the
    # plain version against itself with chunks of 32 calibrates how far
    # the logits may move; check_wkv_layers holds the kernel itself to one
    # bf16 step on every layer's real inputs.
    scan = rwkv_mod.rwkv6_scan
    scan.decode_launches = 0
    launches = {"prefill": prefill(torch, model, params, cfg, dev, rwkv_mod.rwkv6_scan,
                                   {"wkv": chunked_wkv}, {"chunk": 64},
                                   [{"wkv": functools.partial(chunked_wkv, chunk=32)}],
                                   counters=("launches", "chunked_launches"))}
    if scan.decode_launches:
        fail(f"{cfg.name} prefill: {scan.decode_launches} rwkv6_scan launches on the decode kernel")
    torch.cuda.empty_cache()
    check_wkv_layers(torch, model, params, cfg, dev)
    torch.cuda.empty_cache()
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    scan.decode_launches = 0
    served = serve_engine(torch, model, qparams, cfg, dev, kmod,
                          {rwkv_mod.rwkv6_scan: cfg.num_layers, fix_mod.fixmatmul: 1})
    launches["serve"] = served["rwkv6_scan"]
    if scan.decode_launches != launches["serve"]:
        fail(f"{cfg.name} serve: {scan.decode_launches} of {launches['serve']} rwkv6_scan launches "
             f"on the decode kernel")
    print(f"serve: {cfg.name} rwkv6_scan {scan.decode_launches} of {launches['serve']} decode-step "
          f"launches on the decode kernel, 0 of {launches['prefill']} prefill launches", flush=True)
    profile_decode(torch, model, qparams, cfg, dev)
    del qparams
    torch.cuda.empty_cache()

    # small input, held against the CPU: the SMOKE config's quantized
    # engine gives the same greedy tokens on the card as on the CPU
    small = get_smoke(RWKV_ARCH)
    cpu_model, gpu_model = build_model(small, "cpu"), build_model(small, dev)
    p_cpu = quantize_params(cpu_model.init(SEED))
    p_gpu = tree_map_with_names(lambda _, x: x.to(dev), p_cpu)
    prompts = torch.randint(0, small.vocab_size, (3, 12),
                            generator=torch.Generator().manual_seed(SEED)).tolist()
    before = rwkv_mod.rwkv6_scan.launches
    on_cpu = ServeEngine(cpu_model, p_cpu, ServeConfig(), max_len=40).generate(prompts, 20)
    on_gpu = ServeEngine(gpu_model, p_gpu, ServeConfig(), max_len=40).generate(prompts, 20)
    if rwkv_mod.rwkv6_scan.launches == before:
        fail("the SMOKE engine on the card did not launch rwkv6_scan")
    if on_gpu != on_cpu:
        fail(f"SMOKE {RWKV_ARCH} quantized engine: card tokens {on_gpu} != CPU tokens {on_cpu}")
    print(f"serve: SMOKE {RWKV_ARCH} quantized engine, 3 prompts of 12, 20 greedy tokens: "
          f"card tokens equal the CPU's", flush=True)
    return launches, served["fixmatmul"]


def check_wkv_layers(torch, model, params, cfg, dev) -> None:
    """The kernel against its plain version on the prefill's own inputs,
    layer by layer (each layer's input comes from the kernel's path)."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv
    from repro_torch.models.rwkv6 import chunked_wkv

    errs = []

    def checking(r, k, v, logw, u, state, K):
        out, s1 = wkv(r, k, v, logw, u, state, K)
        ref, ref_s1 = chunked_wkv(r, k, v, logw, u, state, K)
        errs.append(torch.stack([(out.float() - ref).abs().max() / ref.abs().max().clamp(min=1),
                                 (s1 - ref_s1).abs().max() / ref_s1.abs().max().clamp(min=1)]))
        return out, s1

    model.forward(params, {"tokens": prefill_tokens(torch, cfg, dev)}, wkv=checking)
    out_rel, s_rel = (float(x) for x in torch.stack(errs).amax(0))
    tol = RWKV_TOL["bfloat16"]
    print(f"check rwkv6_scan on the prefill's inputs, {len(errs)} layers: out max abs err "
          f"{out_rel:.3g} of the largest (tolerance {tol}), state {s_rel:.3g} "
          f"(tolerance {RWKV_STATE_TOL})", flush=True)
    if len(errs) != cfg.num_layers or out_rel > tol or s_rel > RWKV_STATE_TOL:
        fail(f"rwkv6_scan on the prefill's inputs: out {out_rel}, state {s_rel}")


def decode_launches(cfg, qparams) -> tuple:
    """(the ``{"q", "s"}`` leaves ``quantize_params`` made, the fixmatmul
    launches of one decode step): one launch a quantized leaf the step
    reaches (``qlinear``).  The hybrid family's shared block runs
    num_layers // attn_every times a step; whisper's decode never runs
    the encoder, and its cross attention's wk/wv project the encoder's
    output only, so those leaves are quantized but idle."""
    from repro_torch.utils.tree import tree_flatten_with_names

    names = [n[:-2] for n, _ in tree_flatten_with_names(qparams) if n.endswith("/q")]
    if cfg.family == "hybrid":
        apps = cfg.num_layers // (cfg.attn_every or 6)
        return len(names), sum(apps if n.startswith("shared/") else 1 for n in names)
    if cfg.family == "encdec":
        idle = ("xattn/wk", "xattn/wv")
        return len(names), sum(not (n.startswith("enc_layers/") or n.endswith(idle))
                               for n in names)
    return len(names), len(names)


def plain_attention_pair():
    """The plain attention the prefill holds flash against, and the same
    with its blocks of 512 and of 256 (its sums in two other orders),
    which calibrate how far the logits move when only the order of the
    sums changes: in an MoE layer such a change can move a token to
    another expert, and past an expert's capacity that moves which
    tokens drop."""
    from repro_torch.models.attention import blocked_attention

    return ({"attention": blocked_attention},
            [{"attention": functools.partial(blocked_attention, q_block=b, k_block=b)}
             for b in (512, 256)])


def hd_pad(cfg) -> int:
    """The bf16 flash instance a model's attention takes: head_dim rounded
    up to 16 (``flashattn.route`` on aligned operands)."""
    return -(-cfg.head_dim // 16) * 16


def check_attention_layers(torch, model, params, cfg, dev, seq, batch=None,
                           calls: dict | None = None) -> None:
    """Flash against its plain version on the prefill's own inputs, call
    by call (each call's q, k, v come from the kernel's path): the max
    abs error over max(1, the call's largest |output|) within FLASH_TOL
    in bf16, whose step is relative (qk-normed layers give outputs past 4,
    where one bf16 step is 0.03).  The calls, by (causal, Sk, the
    instance's HD_PAD), must be ``calls`` (default: one causal call a
    layer at S ``seq``); ``batch`` replaces the random tokens."""
    from repro_torch.kernels.flashattn.flashattn import route
    from repro_torch.kernels.flashattn.ops import attention
    from repro_torch.models.attention import blocked_attention

    errs, seen = [], {}

    def checking(q, k, v, *, causal, window):
        out = attention(q, k, v, causal=causal, window=window)
        ref = blocked_attention(q, k, v, causal=causal, window=window)
        errs.append((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1))
        key = (causal, k.shape[1], route(*(t.movedim(1, 2) for t in (q, k, v))).hd_pad)
        seen[key] = seen.get(key, 0) + 1
        return out

    batch = batch or {"tokens": prefill_tokens(torch, cfg, dev, seq)}
    model.forward(params, batch, attention=checking)
    err = float(torch.stack(errs).max())
    tol = FLASH_TOL["bfloat16"]
    named = {f"{'causal' if c else 'non-causal'} Sk {sk} HD_PAD {pad}": n
             for (c, sk, pad), n in sorted(seen.items())}
    print(f"check flash on {cfg.name}'s prefill inputs, calls {named}: max abs err "
          f"{err:.3g} of the largest output (tolerance {tol})", flush=True)
    want = calls or {(True, seq, hd_pad(cfg)): cfg.num_layers}
    if seen != want or not err <= tol:
        fail(f"flash on {cfg.name}'s prefill inputs: calls {seen}, not {want}; max abs err {err} "
             f"of the largest output")


def serve_moe(torch, dev, fix_mod, flash_mod, kmod):
    """Phase 7g: qwen2-moe-a2.7b at full width and depth on the int8 KV
    cache.  Returns the fixmatmul and flash launches of its main path."""
    from repro_torch.config import ServeConfig, get_smoke
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.quantized import quantize_params
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_map_with_names

    t0 = time.perf_counter()
    cfg, model, params = build_full(torch, MOE_ARCH, dev, kv_cache_dtype="int8")

    # (a) prefill through the flash kernel's head_dim-128 instance, against
    # the plain attention
    plain, alt = plain_attention_pair()
    launches_flash = prefill(torch, model, params, cfg, dev, flash_mod.flash_attention, plain,
                             {"window": None, "head_dim": cfg.head_dim}, alt,
                             counters=("launches", "tc_launches"))
    torch.cuda.empty_cache()
    check_attention_layers(torch, model, params, cfg, dev, PREFILL_LEN)
    torch.cuda.empty_cache()

    # (b) quantize (attention and lm_head; the experts and the router stay
    # bf16), then serve on the int8 KV cache with the VM fleet as the
    # measuring job
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    _, per_step = decode_launches(cfg, qparams)
    print(f"serve: {cfg.name} {per_step} quantized projections, so {per_step} fixmatmul launches "
          f"a decode step", flush=True)
    launches_fix = serve_engine(torch, model, qparams, cfg, dev, kmod,
                                {fix_mod.fixmatmul: per_step})["fixmatmul"]

    # (d) where a decode step's device time goes, by layer of the step
    prof = profile_decode(torch, model, qparams, cfg, dev, ranges={
        "expert products": (moe_mod, "mlp_swiglu"), "moe": (tf, "moe_sorted"),
        "attention": (tf, "decode_attention")})
    if prof is not None:
        groups, ranges, busy_share = prof
        if all(v > 0 for v in ranges.values()):
            split = {"expert products (routed + shared)": ranges["expert products"],
                     "moe routing, dispatch and combine": ranges["moe"] - ranges["expert products"],
                     "attention (int8 KV decode)": ranges["attention"],
                     "fixmatmul": groups.get("fixmatmul", 0.0)}
            split["other (norms, rope, residuals, embedding, copies)"] = (
                sum(groups.values()) - sum(split.values()))
            print(json.dumps({"phase": "decode_profile_layers", "arch": cfg.name,
                              "device_ms_per_step": split, "device_busy_share": busy_share}),
                  flush=True)
        else:
            print("profile: the ranges recorded no device time (by layer: not measured)",
                  flush=True)
    del qparams
    torch.cuda.empty_cache()

    # (c) small input, held against the CPU: the SMOKE config's quantized
    # engine on the int8 KV cache gives the same greedy tokens on the card
    small = get_smoke(MOE_ARCH).replace(kv_cache_dtype="int8")
    cpu_model, gpu_model = build_model(small, "cpu"), build_model(small, dev)
    p_cpu = quantize_params(cpu_model.init(SEED))
    p_gpu = tree_map_with_names(lambda _, x: x.to(dev), p_cpu)
    prompts = torch.randint(0, small.vocab_size, (3, 12),
                            generator=torch.Generator().manual_seed(SEED)).tolist()
    before = fix_mod.fixmatmul.launches
    on_cpu = ServeEngine(cpu_model, p_cpu, ServeConfig(), max_len=40).generate(prompts, 20)
    on_gpu = ServeEngine(gpu_model, p_gpu, ServeConfig(), max_len=40).generate(prompts, 20)
    if fix_mod.fixmatmul.launches == before:
        fail(f"the SMOKE {MOE_ARCH} engine on the card did not launch fixmatmul")
    if on_gpu != on_cpu:
        fail(f"SMOKE {MOE_ARCH} quantized engine, int8 KV cache: card tokens {on_gpu} != CPU "
             f"tokens {on_cpu}")
    print(f"serve: SMOKE {MOE_ARCH} quantized engine on the int8 KV cache, 3 prompts of 12, 20 "
          f"greedy tokens: card tokens equal the CPU's", flush=True)
    print(json.dumps({"phase": "moe_serve_wall", "arch": MOE_ARCH,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return launches_fix, launches_flash


def serve_others(torch, dev, fix_mod, flash_mod, kmod):
    """Phase 7h: the other four configs at full width (OTHER_ARCHS names
    each one's depth), one at a time: prefill at B 1, S SHORT_LEN through
    flash against the plain attention, then SHORT_NEW greedy tokens for 8
    prompts of SHORT_PROMPT on the quantized engine with the int8 KV
    cache.  Returns the fixmatmul and flash launches."""
    from repro_torch.models.quantized import quantize_params

    t0 = time.perf_counter()
    launches_fix = launches_flash = 0
    plain, alt = plain_attention_pair()
    for arch, layers in OTHER_ARCHS:
        t = time.perf_counter()
        cfg, model, params = build_full(torch, arch, dev, layers=layers, kv_cache_dtype="int8")
        launches_flash += prefill(torch, model, params, cfg, dev, flash_mod.flash_attention, plain,
                                  {"window": None, "head_dim": cfg.head_dim,
                                   "query_groups": cfg.num_heads // cfg.num_kv_heads}, alt,
                                  counters=("launches", "tc_launches"), seq=SHORT_LEN)
        torch.cuda.empty_cache()
        check_attention_layers(torch, model, params, cfg, dev, SHORT_LEN)
        torch.cuda.empty_cache()
        qparams = quantize_params(params)
        del params
        torch.cuda.empty_cache()
        launches_fix += serve_engine(torch, model, qparams, cfg, dev, kmod,
                                     {fix_mod.fixmatmul: decode_launches(cfg, qparams)[1]},
                                     prompt_len=SHORT_PROMPT, new_tokens=SHORT_NEW)["fixmatmul"]
        del qparams, model
        torch.cuda.empty_cache()
        print(json.dumps({"phase": "other_serve_wall", "arch": arch, "layers": cfg.num_layers,
                          "wall_s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"phase": "other_serve_wall", "arch": "all four",
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return launches_fix, launches_flash


def family_batch(torch, cfg, dev) -> dict:
    """Phase 7i's prefill input, drawn on the card from the seed: B 1 x
    PREFILL_LEN tokens for the hybrid family; for vlm the stub's
    ``vision_tokens`` patch embeddings and PREFILL_LEN - vision_tokens
    tokens; for encdec B WHISPER_BATCH x ``encoder_ctx`` stub frames and
    WHISPER_TEXT tokens (whisper's text context)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    B, S, front = 1, PREFILL_LEN, None
    if cfg.family == "vlm":
        S -= cfg.vision_tokens
        front = (cfg.vision_tokens, cfg.vision_dim)
    elif cfg.family == "encdec":
        B, S, front = WHISPER_BATCH, WHISPER_TEXT, (cfg.encoder_ctx, cfg.d_model)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)}
    if front is not None:
        batch["frontend"] = torch.randn((B, *front), generator=g, device=dev).to(torch.bfloat16)
    return batch


def family_flash_calls(cfg, batch) -> dict:
    """The flash calls of phase 7i's prefill by (causal, Sk, HD_PAD): the
    shared block's applications (hybrid), the encoder's non-causal calls
    over every frame and the decoder's causal ones (encdec), one a layer
    over patches and text (vlm)."""
    S = batch["tokens"].shape[1]
    if cfg.family == "hybrid":
        return {(True, S, hd_pad(cfg)): cfg.num_layers // (cfg.attn_every or 6)}
    if cfg.family == "encdec":
        return {(False, batch["frontend"].shape[1], hd_pad(cfg)): cfg.num_encoder_layers,
                (True, S, hd_pad(cfg)): cfg.num_layers}
    return {(True, S + cfg.vision_tokens, hd_pad(cfg)): cfg.num_layers}


def profile_prefill_ranges(torch, model, params, batch, ranges: dict) -> dict:
    """Device ms of one forward inside each ``ranges`` ({label: (module,
    function name)}) profiler range, beside the forward's device and wall
    ms; "not measured" where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with in_ranges(ranges), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    out = dict.fromkeys(ranges, 0.0)
    device = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        kind = getattr(ev, "device_type", None)
        if ev.key in ranges and kind == DeviceType.CPU:
            out[ev.key] += us / 1e3
        elif kind == DeviceType.CUDA and ev.key not in ranges:
            device += us / 1e3
    res = {k: (v if v > 0 else "not measured") for k, v in out.items()}
    return {**res, "forward_device_ms": device if device > 0 else "not measured",
            "forward_wall_ms_profiled": wall_ms}


class LogitSpy:
    """The model as the engine sees it, keeping each decode step's last
    logits on the host."""

    def __init__(self, model):
        self._model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *args):
        logits, cache = self._model.decode_step(*args)
        self.logits.append(logits[:, 0].float().cpu())
        return logits, cache


def smoke_engine_vs_cpu(torch, arch, dev, fix_mod) -> None:
    """Phase 7i (c): the SMOKE config's quantized engine, 3 prompts of 12
    and 20 greedy tokens, on the card and on the CPU.  The tokens must be
    equal, or equal up to one argmax where the CPU's two largest logits
    lie within SMOKE_TOL of each other (a near-tie: last-bit differences
    of f32 sums can move an activation's int8 code by one step, which
    moves a logit by up to SMOKE_TOL), with every logit of the steps
    before it within SMOKE_TOL of the CPU's."""
    from repro_torch.config import ServeConfig, get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.quantized import quantize_params
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_map_with_names

    small = get_smoke(arch)
    cpu_model, gpu_model = LogitSpy(build_model(small, "cpu")), LogitSpy(build_model(small, dev))
    p_cpu = quantize_params(cpu_model.init(SEED))
    p_gpu = tree_map_with_names(lambda _, x: x.to(dev), p_cpu)
    prompts = torch.randint(0, small.vocab_size, (3, 12),
                            generator=torch.Generator().manual_seed(SEED)).tolist()
    before = fix_mod.fixmatmul.launches
    on_cpu = ServeEngine(cpu_model, p_cpu, ServeConfig(), max_len=40).generate(prompts, 20)
    on_gpu = ServeEngine(gpu_model, p_gpu, ServeConfig(), max_len=40).generate(prompts, 20)
    if fix_mod.fixmatmul.launches == before:
        fail(f"the SMOKE {arch} engine on the card did not launch fixmatmul")
    what = "card tokens equal the CPU's"
    if on_gpu != on_cpu:
        first = min(next(k for k, (a, b) in enumerate(zip(g, c)) if a != b)
                    for g, c in zip(on_gpu, on_cpu) if g != c)
        step = first - 1                  # the step whose logits chose token ``first``
        row = next(r for r, (g, c) in enumerate(zip(on_gpu, on_cpu)) if g[first] != c[first])
        top2 = cpu_model.logits[step][row].topk(2).values
        gap = float(top2[0] - top2[1])
        drift = max(float((g - c).abs().max())
                    for g, c in zip(gpu_model.logits[:step + 1], cpu_model.logits[:step + 1]))
        if gap > SMOKE_TOL or drift > SMOKE_TOL:
            fail(f"SMOKE {arch} quantized engine: card tokens {on_gpu} != CPU tokens {on_cpu} "
                 f"(first at row {row} position {first}: CPU top-2 gap {gap}, logits up to "
                 f"it within {drift})")
        what = (f"card tokens equal the CPU's up to a near-tie at row {row} position {first} "
                f"(the CPU's top-2 logit gap {gap:.3g}; logits up to it within {drift:.3g}; "
                f"tolerance {SMOKE_TOL})")
    print(f"serve: SMOKE {arch} quantized engine, 3 prompts of 12, 20 greedy tokens: {what}",
          flush=True)


def serve_families(torch, dev, fix_mod, flash_mod, kmod):
    """Phase 7i: zamba2-1.2b (hybrid), whisper-tiny (encdec) and
    internvl2-2b (vlm) at full width and depth, one at a time: (a) the
    prefill (family_batch) through flash against the plain attention, and
    flash against its plain version on each call's own q, k, v (the calls
    of family_flash_calls); (b) quantize_params, then SHORT_NEW greedy
    tokens for 8 prompts of SHORT_PROMPT on the quantized engine with the
    64-node monitor, FAMILY_FIX_PER_STEP fixmatmul launches a step; (c)
    the SMOKE config's quantized engine on the card gives the CPU's
    tokens (smoke_engine_vs_cpu); (d) the wall time, and zamba2's Mamba layers' device ms in
    one prefill.  Returns the fixmatmul and flash launches."""
    from repro_torch.models import mamba2
    from repro_torch.models.quantized import quantize_params

    t0 = time.perf_counter()
    launches_fix = launches_flash = 0
    plain, alt = plain_attention_pair()
    for arch in FAMILY_ARCHS:
        t = time.perf_counter()
        cfg, model, params = build_full(torch, arch, dev)
        batch = family_batch(torch, cfg, dev)
        calls = family_flash_calls(cfg, batch)
        extra = {"family": cfg.family, "head_dim": cfg.head_dim, "flash_calls": {
            f"{'causal' if c else 'non-causal'} Sk {sk} HD_PAD {pad}": n
            for (c, sk, pad), n in calls.items()}}
        if "frontend" in batch:
            extra["frontend"] = list(batch["frontend"].shape)
        launches_flash += prefill(torch, model, params, cfg, dev, flash_mod.flash_attention,
                                  plain, extra, alt, counters=("launches", "tc_launches"),
                                  batch=batch, expected=sum(calls.values()))
        torch.cuda.empty_cache()
        check_attention_layers(torch, model, params, cfg, dev, None, batch=batch, calls=calls)
        if cfg.family == "hybrid":
            prof = profile_prefill_ranges(torch, model, params, batch,
                                          {"mamba layers": (mamba2, "mamba_block")})
            print(json.dumps({"phase": "prefill_profile", "arch": arch,
                              "device_ms": prof}), flush=True)
        del batch
        torch.cuda.empty_cache()
        qparams = quantize_params(params)
        del params
        torch.cuda.empty_cache()
        leaves, per_step = decode_launches(cfg, qparams)
        print(f"serve: {arch} {leaves} quantized leaves, {per_step} fixmatmul launches a decode "
              f"step", flush=True)
        if per_step != FAMILY_FIX_PER_STEP[arch]:
            fail(f"{arch}: {per_step} fixmatmul launches a decode step by the tree, not "
                 f"{FAMILY_FIX_PER_STEP[arch]}")
        launches_fix += serve_engine(torch, model, qparams, cfg, dev, kmod,
                                     {fix_mod.fixmatmul: per_step},
                                     prompt_len=SHORT_PROMPT, new_tokens=SHORT_NEW)["fixmatmul"]
        del qparams, model
        torch.cuda.empty_cache()

        smoke_engine_vs_cpu(torch, arch, dev, fix_mod)              # (c)
        print(json.dumps({"phase": "family_serve_wall", "arch": arch, "layers": cfg.num_layers,
                          "wall_s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"phase": "family_serve_wall", "arch": "all three",
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return launches_fix, launches_flash


def lutact_path(torch, dev, lut_mod) -> int:
    """Phase 7 (f): the public op fixed_sigmoid over int32 activations
    (scale 1:1000, spread past the saturation edge) at LUT_SIZES.  Returns
    lut_sigmoid's launches."""
    from repro_torch.kernels.lutact import fixed_sigmoid
    from repro_torch.kernels.lutact.ref import lut_sigmoid_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    xs = [torch.randint(-12000, 12001, (n, n), generator=g, device=dev, dtype=torch.int32)
          for n in LUT_SIZES]
    lut_mod.lut_sigmoid.launches = 0
    outs = [fixed_sigmoid(x) for x in xs]
    torch.cuda.synchronize()
    launches = lut_mod.lut_sigmoid.launches
    if launches != len(xs):
        fail(f"fixed_sigmoid launched lut_sigmoid {launches} times for {len(xs)} inputs")
    for x, out in zip(xs, outs):
        if out.shape != x.shape or not torch.equal(out, lut_sigmoid_ref(x)):
            fail(f"fixed_sigmoid {tuple(x.shape)}: kernel != plain version")
        exact = torch.sigmoid(x.double() / 1000)
        err = float((out.double() / 1000 - exact).abs().max())
        if err >= 0.01:
            fail(f"fixed_sigmoid {tuple(x.shape)}: max error {err} against the sigmoid >= 1%")
    print(f"lutact: fixed_sigmoid over {[tuple(x.shape) for x in xs]}: {launches} launches, "
          f"equal to the plain version, max error {err:.4f} against the real sigmoid", flush=True)
    return launches


@contextlib.contextmanager
def in_ranges(ranges: dict):
    """Wrap each function of ``ranges`` ({label: (module, function name)})
    in a ``record_function`` range named by its label while the block runs."""
    from torch.profiler import record_function

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call

    saved = {label: getattr(mod, name) for label, (mod, name) in ranges.items()}
    try:
        for label, (mod, name) in ranges.items():
            setattr(mod, name, ranged(label, saved[label]))
        yield
    finally:
        for label, (mod, name) in ranges.items():
            setattr(mod, name, saved[label])


def profile_decode(torch, model, qparams, cfg, dev, ranges: dict | None = None) -> None:
    """Device time of three quantized decode steps by kernel, from
    torch.profiler; the device's busy share of the steps' wall time.
    ``ranges`` ({label: (module, function name)}) wraps each function in a
    ``record_function`` range for the profile only; each range's device
    time (the kernels launched inside it) is printed beside the groups."""
    from torch.profiler import ProfilerActivity, profile

    ranges = ranges or {}
    cache = model.init_cache(SERVE_BATCH, PROMPT_LEN + NEW_TOKENS)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int64, device=dev)
    for _ in range(2):
        _, cache = model.decode_step(qparams, cache, tok)
    torch.cuda.synchronize()
    with in_ranges(ranges), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(3):
            _, cache = model.decode_step(qparams, cache, tok)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    from torch.autograd import DeviceType

    groups: dict = {}
    in_range = dict.fromkeys(ranges, 0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if ev.key in ranges:              # the range on the host (kernels inside it), or on the device
            if getattr(ev, "device_type", None) == DeviceType.CPU:
                in_range[ev.key] += us
            continue
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue                      # host ops; their kernels are listed on their own
        name = ev.key.lower()
        key = ("fixmatmul" if "fixmatmul" in name else
               "rwkv6_scan" if "rwkv6" in name else
               "memcpy/memset" if "memcpy" in name or "memset" in name else
               "gemm (torch)" if any(w in name for w in ("gemm", "cutlass", "gemv", "nvjet")) else
               "reduce/softmax" if "reduce" in name or "softmax" in name else
               "elementwise/other")
        groups[key] = groups.get(key, 0.0) + us
    busy = sum(groups.values())
    if busy <= 0:
        print("profile: torch.profiler recorded no device time (not measured)", flush=True)
        return None
    print(json.dumps({"phase": "decode_profile", "arch": cfg.name, "steps": 3,
                      "wall_ms_per_step": wall_us / 3e3,
                      "device_ms_per_step": {k: v / 3e3 for k, v in sorted(groups.items())},
                      **({"range_device_ms_per_step": {
                          k: (v / 3e3 if v > 0 else "not measured") for k, v in in_range.items()}}
                         if ranges else {}),
                      "device_busy_share": busy / wall_us}), flush=True)
    return ({k: v / 3e3 for k, v in groups.items()}, {k: v / 3e3 for k, v in in_range.items()},
            busy / wall_us)


def time_fixmatmul(torch, fix_mod, dev) -> dict:
    """ms per launch at M = batch for each decode shape, timed alone with
    its weights rotated past the L2 cache: the kernel the planner picks
    (the streaming kernel) and the tiled kernel on the same operands, in
    turns (stream, tiled, tiled, stream).  The kernels line takes the mean
    over danube's decode mix, weighted by launches a step; rwkv6-7b's
    lm_head is timed on a line of its own, outside that mean."""
    from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref
    from repro_torch.kernels.nvcc import sm_count

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    M, sms = SERVE_BATCH, sm_count(dev)
    shapes = [("danube", K, N, n) for K, N, n in danube_gemms()] + [("rwkv6", *lm_head(RWKV_ARCH), 1)]
    shapes += [("qwen2-moe", K, N, n) for K, N, n in moe_gemms()]
    shapes += [("internvl2", *lm_head("internvl2-2b"), 1)]
    per_shape = []
    for arch, K, N, per_step in shapes:
        xq, wq, sx, sw = fix_operands(torch, M, K, N, dev, g)
        copies = max(2, int(-(-2 * L2_BYTES // (K * N))))
        ws = [wq] + [wq.clone() for _ in range(copies - 1)]
        p, tp = fix_mod.plan(M, K, N, sms), fix_mod.tiled_plan(M, K, N, sms)
        if p.kernel != "stream" or not torch.equal(fix_mod.launch(xq, wq, sx, sw, tp),
                                                   fixmatmul_ref(xq, wq, sx, sw)):
            fail(f"fixmatmul timing {(M, K, N)}: plan {p}, or the tiled kernel != plain version")
        stream = lambda i: fix_mod.fixmatmul(xq, ws[i % copies], sx, sw)
        tiled = lambda i: fix_mod.launch(xq, ws[i % copies], sx, sw, tp)
        turns = [cuda_ms(torch, fn) for fn in (stream, tiled, tiled, stream)]
        ms, tiled_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain = cuda_ms(torch, lambda i: fixmatmul_ref(xq, ws[i % copies], sx, sw), reps=5)
        lib, lib_m = library_int_mm(torch, K, N, ws, sx, sw, dev, g)
        nbytes = M * K + K * N + 4 * M + 4 * N + 4 * M * N
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * 2 * M * N * K / INT8_OPS_PER_S
        bound = max(t_bytes, t_ops)
        rec = {"arch": arch, "M": M, "K": K, "N": N, "per_step": per_step, "plan": p._asdict(),
               "tiled_plan": tp._asdict(), "ms": ms, "tiled_ms": tiled_ms, "turns_ms": turns,
               "plain_ms": plain, "library_ms": lib, "library_M": lib_m, "bound_ms": bound,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "x_bound": ms / bound, "tiled_x_bound": tiled_ms / bound}
        print(json.dumps({"phase": "fixmatmul_shape", **rec}), flush=True)
        per_shape.append(rec)
        del ws, xq, wq
    mix = {}
    for arch in ("danube", "rwkv6", "qwen2-moe", "internvl2"):
        rows = [r for r in per_shape if r["arch"] == arch]
        n = sum(r["per_step"] for r in rows)
        mix[arch] = {"launches_per_step": n, **{
            key: (None if any(r[key] is None for r in rows)
                  else sum(r["per_step"] * r[key] for r in rows) / n)
            for key in ("ms", "tiled_ms", "plain_ms", "library_ms", "bound_ms")}}
    print(json.dumps({"phase": "fixmatmul_timing", "M": M, **{
        arch: {"us_per_launch": 1e3 * m["ms"], "tiled_us_per_launch": 1e3 * m["tiled_ms"],
               "bound_us": 1e3 * m["bound_ms"], "x_bound": m["ms"] / m["bound_ms"],
               "tiled_x_bound": m["tiled_ms"] / m["bound_ms"],
               "ms_per_step": m["ms"] * m["launches_per_step"],
               "tiled_ms_per_step": m["tiled_ms"] * m["launches_per_step"],
               "launches_per_step": m["launches_per_step"]}
        for arch, m in mix.items()}}), flush=True)
    d = mix["danube"]
    q = mix["qwen2-moe"]
    print(f"fixmatmul: danube's decode mix at M={M}: {1e3 * d['ms']:.3f} us/launch "
          f"({d['ms'] / d['bound_ms']:.2f}x the {1e3 * d['bound_ms']:.3f} us bound), the tiled "
          f"kernel {1e3 * d['tiled_ms']:.3f} us; rwkv6 lm_head {1e3 * mix['rwkv6']['ms']:.3f} us; "
          f"qwen2-moe's mix {1e3 * q['ms']:.3f} us/launch ({q['ms'] / q['bound_ms']:.2f}x the "
          f"{1e3 * q['bound_ms']:.3f} us bound); internvl2's lm_head {1e3 * mix['internvl2']['ms']:.3f}"
          f" us (torch._int_mm: {mix['internvl2']['library_ms']} ms)", flush=True)
    return {
        "name": "fixmatmul", "route": "cuda",
        "source": "src/repro_torch/kernels/fixmatmul/csrc/fixmatmul.cu",
        "replaces": "src/repro/kernels/fixmatmul/fixmatmul.py:57",
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_shape) else "operations",
        "library_ms": d["library_ms"], "tiled_ms": d["tiled_ms"], "per_shape": per_shape,
        "mix": mix,
    }


def library_int_mm(torch, K, N, ws, sx, sw, dev, g):
    """torch._int_mm plus the two scale multiplies, at the smallest M it
    accepts (it refuses M <= 16).  A yardstick only: the port never calls it."""
    for M in (17, 24, 32):
        xq = torch.randint(-128, 128, (M, K), generator=g, device=dev).to(torch.int8)
        sxm = sx[:1].expand(M).contiguous()
        try:
            fn = lambda i: torch._int_mm(xq, ws[i % len(ws)]).float() * sxm[:, None] * sw[None, :]
            fn(0)
        except RuntimeError:
            continue
        return cuda_ms(torch, fn), M
    return None, None


def time_flash_shape(torch, flash_mod, dev, arch, B=1, S=PREFILL_LEN, causal=True) -> dict:
    """One prefill shape of ``arch``: B 1, S PREFILL_LEN, causal (with the
    arch's window as a mask, if it has one) unless given, bf16 (the
    tensor-core kernel): the kernel, its plain version, SDPA and the
    bound."""
    import torch.nn.functional as F

    from repro_torch.config import get_arch
    from repro_torch.kernels.flashattn.ref import flash_attention_ref

    c = get_arch(arch)
    H, KV, hd, W = c.num_heads, c.num_kv_heads, c.head_dim, c.sliding_window
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    q, k, v = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
               for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    fa = flash_mod.flash_attention
    n, tc = fa.launches, fa.tc_launches
    ms = cuda_ms(torch, lambda i: fa(q, k, v, causal=causal, window=W))
    if fa.tc_launches - tc != fa.launches - n or fa.launches == n:
        fail("flash timing: the bf16 launches did not all take the tensor-core kernel")
    plain = cuda_ms(torch, lambda i: flash_attention_ref(q, k, v, causal=causal, window=W),
                    reps=3, warmup=1)
    if W is None:
        sdpa = dict(is_causal=causal)
    else:
        pos = torch.arange(S, device=dev)
        sdpa = dict(attn_mask=(pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W))
    try:
        lib_fn = lambda i: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa)
        lib_fn(0)
    except TypeError:                     # a torch without enable_gqa: expand the KV heads
        ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        lib_fn = lambda i: F.scaled_dot_product_attention(q, ke, ve, **sdpa)
    lib = cuda_ms(torch, lib_fn, reps=5, warmup=1)
    visible = sum(min(i + 1, W or S) for i in range(S)) if causal else S * S
    flops = 4 * hd * H * B * visible
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops = 1e3 * flops / BF16_FLOPS
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    tflops = flops / (ms * 1e-3) / 1e12
    mask = "causal" if causal else "non-causal"
    print(f"flash timing {arch} B={B} S={S} H={H} KV={KV} hd={hd} W={W} {mask} bf16: {ms:.4f} "
          f"ms/launch ({tflops:.1f} TFLOP/s, {ms / max(t_ops, t_bytes):.2f}x the bound), "
          f"plain {plain:.4f} ms, SDPA ({mask if W is None else 'the window as a mask'}) "
          f"{lib:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms ({flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return {"arch": arch, "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "window": W,
            "causal": causal, "hd_pad": flash_mod.route(q, k, v).hd_pad, "ms": ms,
            "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib,
            "flops": flops, "tflops": tflops}


def time_flash(torch, flash_mod, dev) -> dict:
    """The danube prefill's shape (hd 80, 32 heads over 8, a 4096 window;
    the kernels line keeps its numbers), qwen2-moe's (hd 128, the HD_PAD
    128 instance, 16 heads over 16, causal without a window), and the
    HD_PAD 64 instance at zamba2's shared block (32 over 32, causal) and
    whisper's encoder (B 8, 6 heads, 1500 frames, non-causal)."""
    danube = time_flash_shape(torch, flash_mod, dev, ARCH)
    moe = time_flash_shape(torch, flash_mod, dev, MOE_ARCH)
    zamba = time_flash_shape(torch, flash_mod, dev, "zamba2-1.2b")
    whisper = time_flash_shape(torch, flash_mod, dev, "whisper-tiny", B=WHISPER_BATCH, S=1500,
                               causal=False)
    return {
        "name": "flash_attention", "route": "cuda", "path": "cuda-mma",
        "source": "src/repro_torch/kernels/flashattn/csrc/flashattn_tc.cu",
        "replaces": "src/repro/kernels/flashattn/flashattn.py:97",
        **{k: danube[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "flops", "tflops")},
        "per_shape": [danube, moe, zamba, whisper],
    }


def time_rwkv6_scan(torch, rwkv_mod, dev, launches: dict) -> dict:
    """ms per launch at the prefill's shape (B 1, S 8192) and the decode
    step's (B 8, S 1), bf16, H 64, K 64, each on the route the main path
    takes there (the two passes, the decode kernel); the kernels line
    takes their mean weighted by the main path's launches of each.  At
    either shape the one-block kernel is timed in turns with the route
    (route, one block, one block, route) and held to the same outputs; at
    the prefill shape torch.profiler splits the two passes' device time.
    The decode shape's states rotate through copies past the L2 cache, as
    32 layers' states find it cold."""
    from repro_torch.config import get_arch
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    c = get_arch(RWKV_ARCH)
    K = c.ssm_head_dim
    H = c.d_model // K
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    per, w = {}, {"prefill": launches["prefill"], "serve": launches["serve"]}
    for path, B, S in (("prefill", 1, PREFILL_LEN), ("serve", SERVE_BATCH, 1)):
        r, k, v, logw, u, s0 = rwkv6_inputs(torch, B, H, S, K, torch.bfloat16, dev, g)
        L = min(64, S)
        kernel = rwkv_mod.route(S)
        state_bytes = 4 * B * H * K * K
        copies = max(1, int(-(-2 * L2_BYTES // state_bytes))) if S == 1 else 1
        states = [s0] + [s0.clone() for _ in range(copies - 1)]

        def call(i, kern=kernel):
            return rwkv_mod.rwkv6_scan(r, k, v, logw, u, states[i % copies], kernel=kern)

        runs = {kernel: [], "one_block": []}
        for kern in (kernel, "one_block", "one_block", kernel):
            runs[kern].append(cuda_ms(torch, functools.partial(call, kern=kern)))
        ms, one_ms = (sum(runs[x]) / 2 for x in (kernel, "one_block"))
        (out, s1), (one, one_s1) = call(0), call(0, "one_block")
        torch.cuda.synchronize()
        rel, s_rel = rwkv6_rel(out, s1, one, one_s1)
        if rel > RWKV_TOL["bfloat16"] or s_rel > RWKV_STATE_TOL:
            fail(f"rwkv6_scan at the {path} shape: {kernel} vs one block: out {rel}, state {s_rel}")
        extra = {"route": kernel, "one_block_ms": one_ms, "runs_ms": runs, "speedup": one_ms / ms,
                 f"{kernel}_vs_one_block": {"out": rel, "state": s_rel}}
        if kernel == "chunked":
            extra |= profile_passes(torch, call)
        del out, s1, one, one_s1
        plain = cuda_ms(torch, lambda i: rwkv6_scan_ref(r, k, v, logw, u, states[i % copies]),
                        reps=3, warmup=1)
        n = B * H * S * K
        nbytes = 2 * 4 * n + 4 * n + 2 * state_bytes          # r, k, v, out; logw; two states
        chunks = B * H * (S // L)
        exps = chunks * (L * (L - 1) // 2) * K
        # f32 flops: A (r k e, two products and a sum), r_dec @ S0, A @ v, k_dec^T @ v
        flops = chunks * (3 * (L * (L - 1) // 2) * K + 2 * L * K * K
                          + (L * (L - 1) // 2) * K * 2 + 2 * L * K * K)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_exp, t_flops = 1e3 * exps / SFU_PER_S, 1e3 * flops / FP32_FLOPS
        t_ops = max(t_exp, t_flops)         # the SFU and the FMA pipes issue side by side
        per[path] = {"B": B, "S": S, "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "exps": exps, "flops": flops, **extra}
        turns = (f", one-block kernel in turns {one_ms:.5f} ms ({extra['speedup']:.2f}x; "
                 f"{ms / one_ms:.3f} of it)" + (
                     f", state pass {extra['state_pass_ms']} ms, output pass "
                     f"{extra['output_pass_ms']} ms" if kernel == "chunked" else "") +
                 f", {max(t_bytes, t_ops) / ms:.3f} of the bound's rate")
        print(f"rwkv6_scan timing B={B} H={H} S={S} K={K} L={L} bf16 ({kernel}): {ms:.5f} "
              f"ms/launch{turns}, plain {plain:.4f} ms, bound {max(t_bytes, t_ops):.6f} ms "
              f"({per[path]['bound_by']}: {nbytes / 1e6:.2f} MB = {t_bytes:.6f} ms, "
              f"{exps / 1e9:.4f} G exp = {t_exp:.6f} ms, {flops / 1e9:.3f} GFLOP f32 = "
              f"{t_flops:.6f} ms); no library call computes it", flush=True)
        del states, r, k, v, logw
    total = sum(w.values())
    mean = {key: sum(w[p] * per[p][key] for p in per) / total for key in ("ms", "plain_ms", "bound_ms")}
    heaviest = max(per, key=lambda p: w[p] * per[p]["bound_ms"])
    return {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:85",
        **mean, "bound_by": per[heaviest]["bound_by"], "library_ms": None, "per_shape": per,
    }


def profile_passes(torch, call, reps: int = 5) -> dict:
    """Device ms a launch of the state pass and of the output pass over
    ``reps`` calls of ``call`` (the two passes), from torch.profiler: each
    kernel's device time over the launches it recorded; "not measured"
    where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            call(i)
        torch.cuda.synchronize()
    us = {"state_pass_ms": [0.0, 0], "output_pass_ms": [0.0, 0]}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        key = ("state_pass_ms" if "rwkv6_state_kernel" in ev.key else
               "output_pass_ms" if "rwkv6_chunk_out_kernel" in ev.key else None)
        if key:
            us[key][0] += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            us[key][1] += ev.count
    return {key: t / 1e3 / n if n else "not measured" for key, (t, n) in us.items()}


def time_lut_sigmoid(torch, lut_mod, dev) -> dict:
    """ms per launch over int32 (n, n) for n in LUT_SIZES; the kernels line
    takes the largest, past the L2 cache.  Bound: 8 bytes per element."""
    from repro_torch.kernels.lutact.ref import lut_sigmoid_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    per = {}
    for n in LUT_SIZES:
        x = torch.randint(-12000, 12001, (n, n), generator=g, device=dev, dtype=torch.int32)
        ms = cuda_ms(torch, lambda i: lut_mod.lut_sigmoid(x))
        plain = cuda_ms(torch, lambda i: lut_sigmoid_ref(x), reps=5)
        bound = 1e3 * 8 * n * n / HBM_BYTES_PER_S
        per[f"{n}x{n}"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound}
        print(f"lut_sigmoid timing {n}x{n} int32: {ms:.5f} ms/launch, plain {plain:.5f} ms, bound "
              f"{bound:.6f} ms (bytes: {8 * n * n / 1e6:.1f} MB); no library call computes it",
              flush=True)
        del x
    big = per[f"{LUT_SIZES[-1]}x{LUT_SIZES[-1]}"]
    return {
        "name": "lut_sigmoid", "route": "cuda",
        "source": "src/repro_torch/kernels/lutact/csrc/lutact.cu",
        "replaces": "src/repro/kernels/lutact/lutact.py:58",
        **big, "bound_by": "bytes", "library_ms": None, "per_shape": per,
    }


# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

def check_flash_bwd(torch, flash_mod, dev) -> dict:
    """Phase 9 (a): the backward kernel at the main paths' shapes against
    its plain version (held to FLASH_BWD_TOL of the plain version's largest
    value), from the forward kernel's output and lse, which are held
    against the plain forward first (the output, from the training
    instance of the forward, to FLASH_TOL of max(1, its largest |value|),
    as phase 7 holds the serve instance; lse to 1e-3); each shape's kernel
    ms (CUDA events), plain ms, SDPA's backward ms through autograd (with
    enable_gqa, the window as a mask) and its bound: 2.5 times the
    forward's visible-pair FLOPs at the bf16 tensor-core or the FP32
    rate, against the bytes it must move.  Returns the kernels-line record
    (danube's shape, without launches)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flashattn.ref import flash_attention_bwd_ref, flash_attention_lse_ref

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [  # (label, B, H, KV, S, hd, causal, window, dtype)
        ("danube", 1, 32, 8, TRAIN_SEQ, 80, True, 4096, bf16),
        ("danube_s8192_w4096", 1, 32, 8, 8192, 80, True, 4096, bf16),
        ("qwen2-moe_hd128", 1, 16, 16, TRAIN_SEQ, 128, True, None, bf16),
        ("zamba2_hd64", 1, 32, 32, TRAIN_SEQ, 64, True, None, bf16),
        ("whisper_encoder", WHISPER_BATCH, 6, 6, 1500, 64, False, None, bf16),
        ("danube_f32", 1, 32, 8, 2048, 80, True, 4096, f32),
    ]
    fa = flash_mod.flash_attention
    per, worst = [], 0.0
    for label, B, H, KV, S, hd, causal, window, dt in shapes:
        g = torch.Generator(device=dev).manual_seed(SEED + S + hd)
        q, k, v, dout = (torch.randn(sh, generator=g, device=dev).to(dt)
                         for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
        out, lse = flash_mod.flash_attention_fwd(q, k, v, causal=causal, window=window)
        out_ref, lse_ref = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
        out_err = float((out.float() - out_ref.float()).abs().max()
                        / out_ref.float().abs().max().clamp(min=1))
        lse_err = float((lse - lse_ref).abs().max())
        del out_ref
        n, ntc = fa.bwd_launches, fa.bwd_tc_launches
        grads = flash_mod.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
        refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
        torch.cuda.synchronize()
        want_tc = flash_mod.BWD_TC_KERNELS if dt == bf16 else 0
        if (fa.bwd_launches - n, fa.bwd_tc_launches - ntc) != (flash_mod.BWD_KERNELS, want_tc):
            fail(f"flash backward {label}: launched {fa.bwd_launches - n} kernels, "
                 f"{fa.bwd_tc_launches - ntc} on the tensor cores")
        fwd_tol = FLASH_TOL[str(dt).split(".")[1]]
        if out.dtype != dt or out.shape != q.shape or not out_err <= fwd_tol:
            fail(f"flash forward with lse {label}: output max abs err {out_err} of max(1, the "
                 f"largest |output|) (tolerance {fwd_tol})")
        rel = {name: float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for name, a, b in zip(("dq", "dk", "dv"), grads, refs)}
        abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads, refs))
        tol = FLASH_BWD_TOL[str(dt).split(".")[1]]
        if max(rel.values()) > tol or lse_err > 1e-3 or any(
                a.dtype != dt or a.shape != t.shape for a, t in zip(grads, (q, k, v))):
            fail(f"flash backward {label}: relative errors {rel} (tolerance {tol}), lse {lse_err}")
        if dt == bf16:
            worst = max(worst, abs_err)
        del grads, refs
        ms = cuda_ms(torch, lambda i: flash_mod.flash_attention_bwd(q, k, v, out, lse, dout,
                                                                    causal=causal, window=window))
        plain = cuda_ms(torch, lambda i: flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                                 causal=causal, window=window),
                        reps=2, warmup=1)
        if window is None or window >= S:
            sdpa = dict(is_causal=causal)
        else:
            pos = torch.arange(S, device=dev)
            sdpa = dict(attn_mask=(pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        try:
            o = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **sdpa)
        except TypeError:                   # a torch without enable_gqa: expand the KV heads
            o = F.scaled_dot_product_attention(
                leaves[0], *(t.repeat_interleave(H // KV, dim=1) for t in leaves[1:]), **sdpa)
        lib = cuda_ms(torch, lambda i: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                      reps=5, warmup=1)
        del o, leaves
        visible = sum(min(i + 1, window or S) for i in range(S)) if causal else S * S
        flops = 2.5 * 4 * hd * H * B * visible
        esize = q.element_size()
        nbytes = esize * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()   # q out dout dq; k v dk dv
        t_ops = 1e3 * flops / (BF16_FLOPS if dt == bf16 else FP32_FLOPS)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes)
        row = {"shape": label, "B": B, "H": H, "KV": KV, "S": S, "hd": hd, "causal": causal,
               "window": window, "dtype": str(dt).split(".")[1], "ms": ms, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops,
               "rel_err": rel, "max_abs_err": abs_err, "fwd_out_err": out_err,
               "lse_max_abs_err": lse_err}
        per.append(row)
        print(json.dumps({"phase": "flash_bwd", **row, "x_bound": ms / bound}), flush=True)
        del q, k, v, dout, out, lse, lse_ref
        torch.cuda.empty_cache()
    d = per[0]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flashattn/csrc/flashattn_bwd.cu",
            "replaces": "src/repro/models/attention.py:42",
            "max_abs_err": worst,
            **{k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "per_shape": per}


def _train_parts(torch, cfg, dev, tcfg):
    from repro_torch.models import build_model
    from repro_torch.train.train_step import init_train_state

    model = build_model(cfg, dev)
    t = time.perf_counter()
    state = init_train_state(model, tcfg, SEED)
    torch.cuda.synchronize()
    return model, state, time.perf_counter() - t


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def train_run(torch, dev, cfg, batch: int, steps: int, counters: dict, per_step: dict,
              seq: int = TRAIN_SEQ, step_info=None) -> dict:
    """``steps`` steps of ``cfg`` (bf16, AdamW, remat) through
    ``Trainer.run_slice`` on the synthetic pipeline at ``seq`` tokens and
    global batch ``batch`` (the launcher's ``TrainConfig``: warmup
    max(steps // 20, 1)), the encdec and vlm families' stub frontend
    (``frontend_of``) added to each batch in ``put_batch``; each step
    timed, with its peak memory, the growth of each of ``counters`` (name
    -> a reader of a launch count) and ``step_info(metrics)``, printed as
    a ``train_step`` line.  Tokens a step are the positions the decoder
    runs: batch x (seq + the vlm's patches).  Fails unless every step
    grows each counter named in ``per_step`` by the count given there, and
    every loss and grad_norm is finite, the first loss within 1 of
    ln(vocab).  Returns the run's summary (steps, ms and tokens/s after
    the first, peak GB, losses)."""
    from repro_torch.config import SHAPES, RunConfig, TrainConfig
    from repro_torch.resilience.voting import ReplicaVoter
    from repro_torch.train.data import pipeline_for
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer

    shape = SHAPES["train_4k"].replace(seq_len=seq, global_batch=batch)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=max(steps // 20, 1))
    model, state, init_s = _train_parts(torch, cfg, dev, tcfg)
    step_fn = make_train_step(model, tcfg)
    front = frontend_of(torch, cfg, dev)
    tokens = batch * (seq + (cfg.vision_tokens if cfg.family == "vlm" else 0))
    records, card = [], card_line()

    def stepped(state, b):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {name: read() for name, read in counters.items()}
        t = time.perf_counter()
        state, m = step_fn(state, b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        records.append({"step": int(state.step), "loss": loss, "grad_norm": gnorm, "ms": 1e3 * dt,
                        "tokens_per_s": tokens / dt,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        **{name: read() - before[name] for name, read in counters.items()},
                        **(step_info(m) if step_info else {})})
        print(json.dumps({"phase": "train_step", "arch": cfg.name, **records[-1], "card": card}),
              flush=True)
        return state, m

    def put_batch(b):
        out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        return out if front is None else out | {"frontend": front(batch)}

    pipeline = pipeline_for(cfg, shape, seed=SEED)
    trainer = Trainer(RunConfig(model=cfg, shape=shape, train=tcfg), stepped, state, pipeline,
                      voter=ReplicaVoter(n_replicas=1), put_batch=put_batch)
    try:
        t = time.perf_counter()
        last = trainer.run_slice(steps)
        wall = time.perf_counter() - t
    finally:
        pipeline.close()
    for st in records:
        wrong = {name: st[name] for name, n in per_step.items() if st[name] != n}
        if wrong:
            fail(f"train {cfg.name} step {st['step']}: launches {wrong}, expected {per_step}")
        if not all(map(math.isfinite, (st["loss"], st["grad_norm"]))):
            fail(f"train {cfg.name} step {st['step']}: loss {st['loss']}, grad_norm {st['grad_norm']}")
    if len(records) != steps or trainer.current_step() != steps or \
            trainer.log.losses[-1] != last["loss"]:
        fail(f"train {cfg.name}: {len(records)} steps, at step {trainer.current_step()}")
    if abs(records[0]["loss"] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"train {cfg.name}: first loss {records[0]['loss']} is not near ln(vocab) "
             f"{math.log(cfg.vocab_size)}")
    warm = records[1:]
    del trainer, state, model, step_fn
    return {"steps": steps, "optimizer": tcfg.optimizer, "remat": cfg.remat, "init_s": init_s,
            "wall_s": wall, "step_ms_mean_after_first": sum(x["ms"] for x in warm) / len(warm),
            "tokens_per_s_after_first": tokens * len(warm) / sum(x["ms"] / 1e3 for x in warm),
            "peak_gb": max(x["peak_gb"] for x in records), "losses": [x["loss"] for x in records]}


def flash_counters(flash_mod) -> dict:
    fa = flash_mod.flash_attention
    return {"flash_fwd": lambda: fa.launches, "flash_bwd": lambda: fa.bwd_launches,
            "flash_fwd_tc": lambda: fa.tc_launches, "flash_bwd_tc": lambda: fa.bwd_tc_launches}


def train_danube(torch, dev, flash_mod) -> tuple:
    """Phase 9 (b): h2o-danube-1.8b whole in bf16 with AdamW, TRAIN_STEPS
    steps at TRAIN_BATCH: 48 forward flash launches a step (24 layers,
    twice under remat, all on the tensor cores) and 24 backward calls of
    BWD_KERNELS launches, BWD_TC_KERNELS of them on the tensor cores.
    Returns (forward, backward) flash launches of the run."""
    from repro_torch.config import SHAPES, get_arch

    cfg = get_arch(ARCH)
    full = SHAPES["train_4k"]
    print(f"train: {ARCH} {cfg.num_layers} layers d {cfg.d_model}, {cfg.param_count():,} params "
          f"in {cfg.dtype}, AdamW, remat={cfg.remat}; {full.name} cut from global batch "
          f"{full.global_batch} to {TRAIN_BATCH} (seq {TRAIN_SEQ}) to fit one card", flush=True)
    fa, L = flash_mod.flash_attention, cfg.num_layers
    fa.launches = fa.tc_launches = fa.bwd_launches = fa.bwd_tc_launches = 0
    run = train_run(torch, dev, cfg, TRAIN_BATCH, TRAIN_STEPS, flash_counters(flash_mod),
                    flash_step_launches(flash_mod, 2 * L, L))
    fwd, bwd = fa.launches, fa.bwd_launches
    print(json.dumps({
        "phase": "train", "arch": ARCH, "layers": L, "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
        "cut_from": {"shape": full.name, "global_batch": full.global_batch}, **run,
        "flash_fwd_launches": fwd, "flash_bwd_launches": bwd,
        "flash_bwd_tc_launches": fa.bwd_tc_launches, "card": card_line(),
    }), flush=True)
    return fwd, bwd


def step_kernel_vs_plain(torch, dev, cfg, plain_kw: dict, counters: dict, expect: dict,
                         leaf_names, phase: str, steps: int = 1, seq: int = TRAIN_SEQ,
                         contexts: dict | None = None, also=()) -> dict:
    """``steps`` AdamW steps of ``cfg`` at TRAIN_CHECK_BATCH x ``seq``
    through the kernels, and the same steps on the same batches (with the
    stub frontend of ``frontend_of`` for encdec and vlm) from a copy of
    the same state with ``plain_kw`` passed to the model's forward (the
    plain version of a kernel); ``contexts[path]``, where given, is a
    context manager each of that path's steps runs inside.  Each step
    grows ``counters`` (name -> reader) by ``expect[path]``.  At every
    step the loss and each metric named in ``also`` within TRAIN_LOSS_TOL
    and grad_norm within TRAIN_GNORM_TOL relative; after the
    first, whose update is lr * g / (|g| + eps), every element of the
    ``leaf_names`` leaves within 2 lr plus the bf16 rounding of both
    results, and TRAIN_LEAF_CLOSE of each leaf within that rounding alone.
    Prints a ``phase`` line (the first step's numbers, and every step's
    under ``per_step``) and returns it."""
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.train.data import pipeline_for
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.utils.tree import tree_flatten_with_names, tree_map

    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model, state, _ = _train_parts(torch, cfg, dev, tcfg)
    copy = lambda t: t.detach().clone()
    plain_state = TrainState(tree_map(copy, state.params), tree_map(copy, state.opt), state.rng,
                             state.step.clone())
    shape = ShapeConfig("check", seq_len=seq, global_batch=TRAIN_CHECK_BATCH, kind="train")
    source = pipeline_for(cfg, shape, seed=SEED + 1).source
    front = frontend_of(torch, cfg, dev)
    contexts = contexts or {}
    fns = {"kernel": make_train_step(model, tcfg), "plain": make_train_step(model, tcfg, **plain_kw)}
    states = {"kernel": state, "plain": plain_state}
    per_step, leaves = [], {}
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(i).items()}
        if front is not None:
            batch["frontend"] = front(TRAIN_CHECK_BATCH)
        runs, extra = {}, {}
        for name in ("kernel", "plain"):
            before = {c: read() for c, read in counters.items()}
            with contexts.get(name, contextlib.nullcontext)():
                (states[name], m), ms = timed(torch, lambda: fns[name](states[name], batch))
            runs[name] = (float(m["loss"]), float(m["grad_norm"]), ms,
                          {c: read() - before[c] for c, read in counters.items()})
            extra[name] = {k: float(m[k]) for k in also}
            if runs[name][3] != expect[name]:
                fail(f"{phase}: step {i + 1}: the {name} step's launches {runs[name][3]}, "
                     f"expected {expect[name]}")
        (kl, kg, kms, kn), (pl, pg, pms, pn) = runs["kernel"], runs["plain"]
        loss_rel, gnorm_rel = abs(kl - pl) / abs(pl), abs(kg - pg) / abs(pg)
        also_rel = {k: abs(extra["kernel"][k] - extra["plain"][k]) / abs(extra["plain"][k])
                    for k in also}
        if loss_rel > TRAIN_LOSS_TOL or gnorm_rel > TRAIN_GNORM_TOL or any(
                r > TRAIN_LOSS_TOL for r in also_rel.values()):
            fail(f"{phase}: step {i + 1}: loss {kl} vs {pl} ({loss_rel:.3g}), grad_norm {kg} vs "
                 f"{pg} ({gnorm_rel:.3g}), {extra} ({also_rel})")
        per_step.append({"loss": [kl, pl], "loss_rel": loss_rel, "grad_norm": [kg, pg],
                         "grad_norm_rel": gnorm_rel, "step_ms": {"kernel": kms, "plain": pms},
                         "launches": {"kernel": kn, "plain": pn},
                         **{k: [extra["kernel"][k], extra["plain"][k]] for k in also},
                         **{f"{k}_rel": r for k, r in also_rel.items()}})
        if i:
            continue
        plain_leaves = dict(tree_flatten_with_names(states["plain"].params))
        for name, a in tree_flatten_with_names(states["kernel"].params):
            if name not in leaf_names:
                continue
            a, b = a.detach().float(), plain_leaves[name].detach().float()
            diff, rounding = (a - b).abs(), 2.0 ** -8 * (a.abs() + b.abs())
            close = float((diff <= rounding + 1e-12).float().mean())
            worst_lr = float(diff.max()) / tcfg.lr
            if not bool((diff <= 2 * tcfg.lr + rounding + 1e-12).all()) or close < TRAIN_LEAF_CLOSE:
                fail(f"{phase}: leaf {name}: {close:.4f} within bf16 rounding, "
                     f"max diff {worst_lr:.3f} lr")
            leaves[name] = {"within_rounding": close, "max_diff_lr": worst_lr}
        if set(leaves) != set(leaf_names):
            fail(f"{phase}: leaves {sorted(set(leaf_names) - set(leaves))} not found")
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "batch": TRAIN_CHECK_BATCH, "seq": seq, "steps": steps, **per_step[0],
            "leaves": leaves, "per_step": per_step, "card": card_line()}
    print(json.dumps(line), flush=True)
    return line


def attention_step_check(torch, dev, flash_mod, cfg, fwd: int, calls: int, leaf_names,
                         phase: str, **kw) -> dict:
    """``step_kernel_vs_plain`` against the plain attention (autograd
    through ``blocked_attention``): the kernel step launches flash's
    forward ``fwd`` times and its backward ``calls`` times, the plain step
    neither; ``kw`` goes to ``step_kernel_vs_plain``."""
    from repro_torch.models.attention import blocked_attention

    counters = {k: v for k, v in flash_counters(flash_mod).items() if k in ("flash_fwd", "flash_bwd")}
    return step_kernel_vs_plain(
        torch, dev, cfg, {"attention": blocked_attention}, counters,
        {"kernel": {"flash_fwd": fwd, "flash_bwd": flash_mod.BWD_KERNELS * calls},
         "plain": {"flash_fwd": 0, "flash_bwd": 0}}, leaf_names, phase, **kw)


def train_kernel_vs_plain(torch, dev, flash_mod) -> None:
    """Phase 9 (c): danube at full width and TRAIN_CHECK_LAYERS layers
    through the kernels against the plain attention (autograd through
    ``blocked_attention``, no flash launch)."""
    from repro_torch.config import get_arch

    L = TRAIN_CHECK_LAYERS
    attention_step_check(
        torch, dev, flash_mod, get_arch(ARCH).replace(num_layers=L), 2 * L, L,
        ("embed/tokens", "layers/0/attn/wq", f"layers/{L - 1}/attn/wk", f"layers/{L - 1}/mlp/w2",
         "lm_head"), "train_check")


# ---------------------------------------------------------------------------
# Phase 10: rwkv6 and zamba2 training
# ---------------------------------------------------------------------------

def rwkv6_plain_bwd(torch, r, k, v, logw, u, s0, dout, ds1) -> list:
    """The plain backward: autograd through ``rwkv6_scan_ref`` (its forward
    and backward), over slices of at most PLAIN_ROWS // (B S) heads, so
    that each chunk's (B, heads, L, L, K) tensors and the graph fit;
    (dr, dk, dv, dlogw, du, dstate0)."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    B, H, S, _ = r.shape
    step = max(1, min(H, PLAIN_ROWS // (B * S)))
    parts = []
    for h0 in range(0, H, step):
        sl = slice(h0, h0 + step)
        leaves = [t[:, sl].detach().requires_grad_(True) for t in (r, k, v, logw)] + [
            u[sl].detach().requires_grad_(True), s0[:, sl].detach().requires_grad_(True)]
        out, s1 = rwkv6_scan_ref(*leaves)
        parts.append(torch.autograd.grad(
            (out * dout[:, sl].float()).sum() + (s1 * ds1[:, sl]).sum(), leaves))
    return [torch.cat([p[i] for p in parts], dim=0 if i == 4 else 1) for i in range(6)]


def sass_mma(lib) -> dict:
    """HMMA instructions (the tensor cores' mma) in each kernel of
    ``lib``'s built library, by mangled name, from ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.run([exe, "-sass", str(lib.path())], capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {lib.path()} failed: {proc.stderr.strip()[-400:]}")
    counts, fn = {}, None
    for ln in proc.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def rwkv6_bwd_design(rwkv_mod) -> dict:
    """Phase 10 (a)'s report of the backward's kernels: each one's HMMA
    count in the library's SASS, ptxas line and resident blocks and warps
    an SM (the occupancy API).  Fails unless both bf16 kernels hold HMMA."""
    lib = rwkv_mod.BWD_LIBRARY
    counts = sass_mma(lib)
    kernels = {  # name: (its key in bwd_occupancy(), threads a block, precision)
        "rwkv6_dstate_tc_kernel": ("dstate_tc", 256, "bf16, tensor cores"),
        "rwkv6_grad_tc_kernel": ("grad_tc", 512, "bf16, tensor cores"),
        "rwkv6_dstate_kernel": ("dstate_f32", 256, "f32, FP32 pipes"),
        "rwkv6_grad_kernel": ("grad_f32", 512, "f32, FP32 pipes"),
    }
    occ = rwkv_mod.bwd_occupancy()
    report = {}
    for name, (occ_key, threads, kind) in kernels.items():
        frag = f"{len(name)}{name}"      # the mangled name's length-prefixed part
        hmma = sum(n for fn, n in counts.items() if frag in fn)
        report[name] = {"precision": kind, "sass_hmma": hmma,
                        "ptxas": ptxas_of(lib, frag)[1:] or ["not in the report"],
                        "blocks_per_sm": occ[occ_key], "warps_per_sm": occ[occ_key] * threads // 32}
        if "tensor" in kind and hmma == 0:
            fail(f"rwkv6_scan backward: {name} holds no HMMA in its SASS")
    print(json.dumps({"phase": "rwkv6_bwd_design", "card": card_line(), "kernels": report}),
          flush=True)
    return report


def check_rwkv6_bwd(torch, rwkv_mod, dev) -> dict:
    """Phase 10 (a): rwkv6_scan's backward kernels at rwkv6-7b's heads (64
    of 64) against the plain backward (``rwkv6_plain_bwd``) from the same
    inputs, the chunk states from the forward kernel: every gradient
    within RWKV_BWD_TOL of the plain version's largest value, every bf16
    call on the tensor-core kernels (``bwd_tc_launches``); each shape's
    kernel ms (CUDA events), plain ms (autograd's forward and backward)
    and bound: the larger of the bytes it must move (inputs, the saved
    states, the gradients, each once) at the HBM rate and its operations,
    each on the pipe that does it exactly, side by side: the pairwise
    exponentials once at the SFU rate; in bf16 the element-weighted
    pairwise sums (8 FLOPs a term) at the FP32 rate and the matmul-shaped
    products (A^T dO, the 8 L K^2 of S dO, G v, (k kdec)^T G and the dstate
    update) at a third of the tensor cores' bf16 rate (an f32 operand in
    three bf16 parts), D = v . dO (two inputs) at the full rate; in f32
    every FLOP at the FP32 rate.  ``bound_fp32_ms`` prices the same shape
    with every f32 FLOP at the FP32 rate (D on the tensor cores in bf16),
    the figure before the products moved to the tensor cores.  Returns the
    kernels-line record (the training shape, without launches)."""
    from repro_torch.config import get_arch

    design = rwkv6_bwd_design(rwkv_mod)
    c = get_arch(RWKV_ARCH)
    K = c.ssm_head_dim
    H = c.d_model // K
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [  # (label, B, S, dtype, decay, d(s1) nonzero)
        ("serve_prefill", 1, PREFILL_LEN, bf16, "slow", False),
        ("train", TRAIN_BATCH, TRAIN_SEQ, bf16, "slow", False),
        ("one_chunk", TRAIN_BATCH, 64, bf16, "slow", False),
        ("f32", 1, 2048, f32, "slow", False),
        ("state_and_ds1", 2, 1024, bf16, "slow", True),
        ("fast_decay", 1, 2048, bf16, "fast", False),
    ]
    bwd = rwkv_mod.rwkv6_scan
    per, worst = [], 0.0
    for label, B, S, dt, decay, with_ds1 in shapes:
        g = torch.Generator(device=dev).manual_seed(SEED + 11 + S + B)
        r, k, v, logw, u, s0 = rwkv6_inputs(torch, B, H, S, K, dt, dev, g, decay)
        dout = torch.randn((B, H, S, K), generator=g, device=dev).to(dt)
        ds1 = (torch.randn((B, H, K, K), generator=g, device=dev) if with_ds1
               else torch.zeros((B, H, K, K), device=dev))
        _, _, states = rwkv_mod._launch(r, k, v, logw, u, s0, 64, keep_states=True)
        n, ntc = bwd.bwd_launches, bwd.bwd_tc_launches
        grads = rwkv_mod.rwkv6_scan_bwd(r, k, v, logw, u, states, dout, ds1)
        torch.cuda.synchronize()
        tc = bwd.bwd_tc_launches - ntc
        if bwd.bwd_launches - n != rwkv_mod.BWD_KERNELS or \
                tc != (rwkv_mod.BWD_TC_KERNELS if dt == bf16 else 0):
            fail(f"rwkv6_scan backward {label}: {bwd.bwd_launches - n} launches, {tc} on the "
                 f"tensor cores")
        refs = rwkv6_plain_bwd(torch, r, k, v, logw, u, s0, dout, ds1)
        names = ("dr", "dk", "dv", "dlogw", "du", "dstate0")
        rel = {name: float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for name, a, b in zip(names, grads, refs)}
        abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads, refs))
        tol = RWKV_BWD_TOL[str(dt).split(".")[1]]
        if max(rel.values()) > tol or any(a.dtype != b.dtype or a.shape != b.shape
                                          for a, b in zip(grads, refs)):
            fail(f"rwkv6_scan backward {label}: relative errors {rel} (tolerance {tol})")
        if dt == bf16:
            worst = max(worst, abs_err)
        del grads, refs
        ms = cuda_ms(torch, lambda i: rwkv_mod.rwkv6_scan_bwd(r, k, v, logw, u, states, dout, ds1))
        plain = cuda_ms(torch, lambda i: rwkv6_plain_bwd(torch, r, k, v, logw, u, s0, dout, ds1),
                        reps=2, warmup=1)
        L = min(64, S)
        n_el, es, chunks = B * H * S * K, r.element_size(), B * H * (S // L)
        pairs = L * (L - 1) // 2
        # r, k, v, dout and logw in; the chunk states; d(s1) in and dstate0 out;
        # dr, dk, dv and dlogw out; du
        nbytes = n_el * (4 * es + 4) + 4 * chunks * K * K + 8 * B * H * K * K + n_el * (3 * es + 4) \
            + 4 * H * K
        exps = chunks * pairs * K
        # FLOPs: A (3 a term) and the dr and dk sums (5), element-weighted;
        # A^T dO (2 a term) and S dO, G v, (k kdec)^T G and the dstate update
        # (2 L K^2 each), matmul-shaped; D[t, i] = v_i . dO_t over i <= t, a
        # product of two inputs
        pair_flops = chunks * 8 * pairs * K
        mm_flops = chunks * (2 * pairs * K + 8 * L * K * K)
        d_flops = chunks * L * (L + 1) * K
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_exp = 1e3 * exps / SFU_PER_S
        t_fp32_all = 1e3 * (pair_flops + mm_flops) / FP32_FLOPS
        if dt == bf16:
            # tensor cores: the split f32 operands' three products, and D exact
            tc_flops = 3 * mm_flops + d_flops
            flops, t_tc = pair_flops, 1e3 * tc_flops / BF16_FLOPS
            bound_fp32 = max(t_bytes, t_exp, t_fp32_all, 1e3 * d_flops / BF16_FLOPS)
        else:
            tc_flops, flops, t_tc = 0, pair_flops + mm_flops + d_flops, 0.0
            bound_fp32 = None
        t_flops = 1e3 * flops / FP32_FLOPS
        t_ops = max(t_exp, t_flops, t_tc)   # the SFU, FMA and tensor pipes run side by side
        bound = max(t_bytes, t_ops)
        bound_fp32 = bound if bound_fp32 is None else bound_fp32
        row = {"shape": label, "B": B, "H": H, "S": S, "K": K, "dtype": str(dt).split(".")[1],
               "decay": decay, "ds1": with_ds1, "ms": ms, "plain_ms": plain, "library_ms": None,
               "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_fp32_ms": bound_fp32, "x_bound_fp32": ms / bound_fp32,
               "tc_launches": tc, "bytes": nbytes, "exps": exps, "flops": flops,
               "tc_flops": tc_flops, "t_bytes_ms": t_bytes,
               "t_exp_ms": t_exp, "t_flops_ms": t_flops, "t_tc_ms": t_tc, "rel_err": rel,
               "max_abs_err": abs_err}
        per.append(row)
        print(json.dumps({"phase": "rwkv6_bwd", **row, "x_bound": ms / bound}), flush=True)
        del r, k, v, logw, u, s0, dout, ds1, states
        torch.cuda.empty_cache()
    d = next(x for x in per if x["shape"] == "train")
    return {"name": "rwkv6_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan_bwd.cu",
            "replaces": "src/repro/models/rwkv6.py:83", "max_abs_err": worst,
            **{k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "bound_fp32_ms")},
            "tensor_core_kernels": [n for n, x in design.items() if "tensor" in x["precision"]],
            "design": design, "per_shape": per}


def rwkv6_counters(rwkv_mod) -> dict:
    scan = rwkv_mod.rwkv6_scan
    return {"rwkv6_fwd": lambda: scan.launches, "rwkv6_chunked": lambda: scan.chunked_launches,
            "rwkv6_bwd": lambda: scan.bwd_launches, "rwkv6_bwd_tc": lambda: scan.bwd_tc_launches}


def train_rwkv6(torch, dev, rwkv_mod) -> tuple:
    """Phase 10 (b), the cell rwkv6-train-4k: rwkv6-7b at full width with
    RWKV_TRAIN_LAYERS of its layers (bf16, AdamW, remat), TRAIN_STEPS
    steps at TRAIN_BATCH x TRAIN_SEQ: every time-mix layer's scan on the
    two passes twice a step (remat) and its backward once.  Returns
    (forward, backward) rwkv6_scan launches of the run."""
    from repro_torch.config import SHAPES, get_arch

    full = get_arch(RWKV_ARCH)
    cfg = full.replace(num_layers=RWKV_TRAIN_LAYERS)
    print(f"train: {RWKV_ARCH} {cfg.num_layers} of {full.num_layers} layers d {cfg.d_model}, "
          f"{cfg.param_count():,} params in {cfg.dtype}, AdamW, remat={cfg.remat}; "
          f"train_4k cut from global batch {SHAPES['train_4k'].global_batch} to {TRAIN_BATCH} "
          f"(seq {TRAIN_SEQ}) to fit one card", flush=True)
    scan, L = rwkv_mod.rwkv6_scan, cfg.num_layers
    scan.launches = scan.chunked_launches = scan.decode_launches = scan.bwd_launches = 0
    scan.bwd_tc_launches = 0
    run = train_run(torch, dev, cfg, TRAIN_BATCH, TRAIN_STEPS, rwkv6_counters(rwkv_mod), {
        "rwkv6_fwd": 2 * L, "rwkv6_chunked": 2 * L, "rwkv6_bwd": rwkv_mod.BWD_KERNELS * L,
        "rwkv6_bwd_tc": rwkv_mod.BWD_TC_KERNELS * L})
    fwd, bwd = scan.launches, scan.bwd_launches
    print(json.dumps({
        "phase": "train", "cell": "rwkv6-train-4k", "arch": RWKV_ARCH, "layers": L,
        "layers_of": full.num_layers, "params": cfg.param_count(), "seq": TRAIN_SEQ,
        "global_batch": TRAIN_BATCH, **run, "rwkv6_fwd_launches": fwd,
        "rwkv6_bwd_launches": bwd, "rwkv6_bwd_tc_launches": scan.bwd_tc_launches,
        "card": card_line()}), flush=True)
    return fwd, bwd


def rwkv6_kernel_vs_plain(torch, dev, rwkv_mod) -> None:
    """Phase 10 (c): rwkv6-7b at full width and RWKV_CHECK_LAYERS layers,
    RWKV_CHECK_STEPS steps through the kernels against the same steps with
    ``wkv=chunked_wkv`` (autograd through the plain scan), the loss and
    grad_norm held at every step.  Every plain function the port has for
    the scan is counted: a kernel step calls none, a plain step calls
    chunked_wkv twice a layer (remat)."""
    from repro_torch.config import get_arch
    from repro_torch.kernels.rwkv6_scan import ref as ref_mod
    from repro_torch.models.rwkv6 import chunked_wkv

    calls = [0]

    def counted(fn):
        def call(*args, **kwargs):
            calls[0] += 1
            return fn(*args, **kwargs)
        return call

    names = ("rwkv6_scan_ref", "chunk_states_ref", "chunk_outputs_ref", "chunk_dstates_ref",
             "chunk_grads_ref")
    saved = {name: getattr(rwkv_mod, name) for name in names}
    saved_ref = ref_mod.chunked_wkv
    L = RWKV_CHECK_LAYERS
    counters = {k: v for k, v in rwkv6_counters(rwkv_mod).items()
                if k not in ("rwkv6_chunked", "rwkv6_bwd_tc")}
    counters["plain_scan"] = lambda: calls[0]
    try:
        for name in names:
            setattr(rwkv_mod, name, counted(saved[name]))
        ref_mod.chunked_wkv = counted(saved_ref)
        step_kernel_vs_plain(
            torch, dev, get_arch(RWKV_ARCH).replace(num_layers=L), {"wkv": counted(chunked_wkv)},
            counters, {"kernel": {"rwkv6_fwd": 2 * L, "rwkv6_bwd": rwkv_mod.BWD_KERNELS * L,
                                  "plain_scan": 0},
                       "plain": {"rwkv6_fwd": 0, "rwkv6_bwd": 0, "plain_scan": 2 * L}},
            ("embed/tokens", "layers/0/time/wk", "layers/0/time/w0", f"layers/{L - 1}/time/wb",
             f"layers/{L - 1}/chan/wv", "lm_head"), "rwkv6_train_check", RWKV_CHECK_STEPS)
    finally:
        for name in names:
            setattr(rwkv_mod, name, saved[name])
        ref_mod.chunked_wkv = saved_ref


def train_zamba2(torch, dev, flash_mod) -> tuple:
    """Phase 10 (d): zamba2-1.2b's train step on the card.  One step at
    full width and ZAMBA_CHECK_LAYERS layers (the shared attention block
    runs once, on flash's HD_PAD 64 forward with lse and its backward)
    against the plain-attention step, as 9 (c); then the whole model for
    ZAMBA_TRAIN_STEPS steps at the largest of ZAMBA_BATCHES that fits.
    Returns (forward, backward) flash launches of the whole-model run."""
    from repro_torch.config import get_arch

    full = get_arch(ZAMBA_ARCH)
    cfg = full.replace(num_layers=ZAMBA_CHECK_LAYERS)
    shared = ZAMBA_CHECK_LAYERS // (cfg.attn_every or 6)
    attention_step_check(
        torch, dev, flash_mod, cfg, shared, shared,
        ("embed/tokens", "layers/0/mamba/wx", f"layers/{cfg.num_layers - 1}/mamba/out_proj",
         "shared/attn/wq", "shared/mlp/w2", "lm_head"), "zamba2_train_check")
    torch.cuda.empty_cache()
    apps = full.num_layers // (full.attn_every or 6)
    return train_cell(torch, dev, flash_mod, full, "zamba2-train-4k", ZAMBA_BATCHES,
                      ZAMBA_TRAIN_STEPS, (apps, apps))[1:]


def flash_step_launches(flash_mod, fwd: int, calls: int) -> dict:
    """A train step's flash launches by counter: ``fwd`` forward launches
    and ``calls`` backward calls, every one on the tensor cores (bf16)."""
    return {"flash_fwd": fwd, "flash_fwd_tc": fwd, "flash_bwd": flash_mod.BWD_KERNELS * calls,
            "flash_bwd_tc": flash_mod.BWD_TC_KERNELS * calls}


def train_cell(torch, dev, flash_mod, cfg, cell: str, batches, steps: int, flash: tuple,
               seq: int = TRAIN_SEQ, layers_of: int | None = None, step_info=None) -> tuple:
    """The cell ``cell``: ``steps`` train steps of ``cfg`` (``train_run``)
    at the largest of ``batches`` that fits (an out-of-memory error moves
    down to the next), each step launching flash ``flash`` = (forward
    launches, backward calls) times; prints the cell's ``train`` line.
    Returns (batch, forward, backward) flash launches of the run."""
    fa = flash_mod.flash_attention
    tried = []
    for batch in batches:
        fa.launches = fa.tc_launches = fa.bwd_launches = fa.bwd_tc_launches = 0
        try:
            run = train_run(torch, dev, cfg, batch, steps, flash_counters(flash_mod),
                            flash_step_launches(flash_mod, *flash), seq, step_info)
        except torch.cuda.OutOfMemoryError:
            tried.append(batch)
            torch.cuda.empty_cache()
            continue
        print(json.dumps({"phase": "train", "cell": cell, "arch": cfg.name,
                          "layers": cfg.num_layers, "layers_of": layers_of or cfg.num_layers,
                          "params": cfg.param_count(), "seq": seq, "global_batch": batch,
                          "out_of_memory_at": tried, **run, "flash_fwd_launches": fa.launches,
                          "flash_fwd_tc_launches": fa.tc_launches,
                          "flash_bwd_launches": fa.bwd_launches,
                          "flash_bwd_tc_launches": fa.bwd_tc_launches, "card": card_line()}),
              flush=True)
        return batch, fa.launches, fa.bwd_launches
    fail(f"train {cell}: out of memory at every batch of {batches}")


# ---------------------------------------------------------------------------
# Phase 13: the MoE family, whisper and internvl2 train
# ---------------------------------------------------------------------------

def frontend_of(torch, cfg, dev):
    """The stub frontend each train batch of an encdec or vlm model
    carries, drawn on the card from the seed as phase 7i's
    ``family_batch``: ``B -> (B, encoder_ctx, d_model)`` frames or ``(B,
    vision_tokens, vision_dim)`` patches in bf16; None for the other
    families."""
    if cfg.family == "encdec":
        shape = (cfg.encoder_ctx, cfg.d_model)
    elif cfg.family == "vlm":
        shape = (cfg.vision_tokens, cfg.vision_dim)
    else:
        return None
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    return lambda B: torch.randn((B, *shape), generator=g, device=dev).to(torch.bfloat16)


class RouterProbe:
    """Phase 13's view into the MoE layers: ``repro_torch.models.moe``'s
    ``router_topk`` and ``_dispatch`` patched for a ``with`` block and
    restored after it.

    * ``record()``: each router call keeps its expert ids, in call order
      (under remat a step calls each layer's router twice: the forward,
      then the recompute in the backward, in reverse layer order).
    * ``replay()``: the i-th router call routes to the i-th kept ids.  Its
      weights are its own probabilities at those ids, normalised as
      ``router_topk`` does, so its router still takes its own gradient.
      Before each call is replayed, its own top-k is compared with the
      kept ids: ``last["routed_apart"]`` counts the assignments it would
      have sent to another expert.  Every kept call must be replayed.
    * ``observe()``: routing as it is.

    In each mode every dispatch adds its assignments dropped by capacity
    and its experts' loads to ``stats()``, which reads and resets them."""

    def __init__(self, torch, moe_mod):
        self.torch, self.moe = torch, moe_mod
        self.router_topk, self.dispatch = moe_mod.router_topk, moe_mod._dispatch
        self.ids, self.last, self._seen = [], {}, []

    @contextlib.contextmanager
    def _patched(self, router_topk):
        def dispatch(xt, router, **kw):
            expert_in, state = self.dispatch(xt, router, **kw)
            keep, ids = state[2], state[1]
            self._seen.append((keep.numel() - keep.sum(), keep.numel(),
                               self.moe._expert_counts(ids, kw["num_experts"])))
            return expert_in, state

        self.moe.router_topk, self.moe._dispatch = router_topk, dispatch
        try:
            yield self
        finally:
            self.moe.router_topk, self.moe._dispatch = self.router_topk, self.dispatch

    def observe(self):
        return self._patched(self.router_topk)

    def record(self):
        self.ids = []

        def router_topk(x, w, k):
            weights, ids, probs = self.router_topk(x, w, k)
            self.ids.append(ids.detach())
            return weights, ids, probs
        return self._patched(router_topk)

    @contextlib.contextmanager
    def replay(self):
        torch, kept = self.torch, iter(self.ids)
        apart, calls = [], [0]

        def router_topk(x, w, k):
            _, own, probs = self.router_topk(x, w, k)
            ids = next(kept)
            apart.append(k * own.shape[:-1].numel()
                         - (own[..., :, None] == ids[..., None, :]).any(-1).sum())
            calls[0] += 1
            weights = torch.gather(probs, -1, ids)
            return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9), ids, probs

        with self._patched(router_topk):
            yield self
        if calls[0] != len(self.ids):
            raise RuntimeError(f"replayed {calls[0]} of {len(self.ids)} recorded router calls")
        self.last = {"router_calls": calls[0],
                     "assignments": sum(int(i.numel()) for i in self.ids),
                     "routed_apart": int(sum(int(a) for a in apart))}

    def stats(self) -> dict:
        """Over the dispatches since the last read: the share of the
        assignments dropped by capacity, and the largest expert's load
        over the mean load of its layer, the largest of the layers'."""
        seen, self._seen = self._seen, []
        if not seen:
            return {}
        dropped = sum(float(d) for d, _, _ in seen) / sum(n for _, n, _ in seen)
        return {"dropped_share": dropped,
                "max_load_over_mean": max(float(c.max() / c.mean()) for _, _, c in seen)}


def moe_kernel_vs_plain(torch, dev, flash_mod, moe_mod) -> dict:
    """Phase 13 (a): qwen2-moe at full width and MOE_CHECK_LAYERS layers,
    one AdamW step through the kernels against the plain-attention step
    (autograd through ``blocked_attention``), the routing of the kernel
    step replayed in the plain one (``RouterProbe``); the aux loss held
    as the loss is.  Returns the check's line."""
    from repro_torch.config import get_arch

    L = MOE_CHECK_LAYERS
    probe = RouterProbe(torch, moe_mod)

    @contextlib.contextmanager
    def replayed():
        with probe.replay():
            yield
        print(json.dumps({"phase": "moe_routing_replay", "arch": MOE_ARCH, "layers": L,
                          **probe.last, "card": card_line()}), flush=True)

    line = attention_step_check(
        torch, dev, flash_mod, get_arch(MOE_ARCH).replace(num_layers=L), 2 * L, L,
        ("embed/tokens", "layers/0/attn/wq", "layers/0/moe/router", f"layers/{L - 1}/moe/router",
         f"layers/{L - 1}/moe/w1", "layers/0/moe/shared/w2", "lm_head"), "moe_train_check",
        contexts={"kernel": probe.record, "plain": replayed}, also=("aux",))
    return line | {"routing": probe.last}


def train_moe(torch, dev, flash_mod, moe_mod) -> tuple:
    """Phase 13 (b): the cell moe-train-4k, qwen2-moe at full width with
    MOE_TRAIN_LAYERS of its layers, MOE_TRAIN_STEPS steps at seq 4096 and
    the largest of TRAIN_BATCHES that fits, each step's line with its aux
    loss, the share of assignments dropped by capacity and the largest
    expert's load over the mean; then qwen3-moe the same way
    (QWEN3_TRAIN).  Returns (qwen2-moe's batch, forward, backward) flash
    launches of both runs."""
    from repro_torch.config import get_arch

    probe = RouterProbe(torch, moe_mod)
    out = []
    for arch, layers, steps, cell in ((MOE_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, "moe-train-4k"),
                                      QWEN3_TRAIN):
        full = get_arch(arch)
        cfg = full.replace(num_layers=layers)
        print(f"train: {arch} {layers} of {full.num_layers} layers d {cfg.d_model}, "
              f"{cfg.param_count():,} params in {cfg.dtype}, {cfg.num_experts} experts top "
              f"{cfg.num_experts_per_tok}, AdamW, remat={cfg.remat}", flush=True)
        with probe.observe():
            out.append(train_cell(torch, dev, flash_mod, cfg, cell, TRAIN_BATCHES, steps,
                                  (2 * layers, layers), layers_of=full.num_layers,
                                  step_info=lambda m: {"aux": float(m["aux"]), **probe.stats()}))
        torch.cuda.empty_cache()
    return out[0][0], sum(o[1] for o in out), sum(o[2] for o in out)


def train_whisper(torch, dev, flash_mod) -> tuple:
    """Phase 13 (c): whisper-tiny whole, one AdamW step at B 1 through
    the kernels against the plain-attention step (encoder and decoder),
    then the cell whisper-train: WHISPER_TRAIN_STEPS steps at WHISPER_TEXT
    text tokens over ``encoder_ctx`` frames at the largest of
    WHISPER_BATCHES that fits.  A step runs flash four times non-causal
    (the encoder) and four times causal (the decoder), each forward twice
    under remat.  Returns (batch, forward, backward) flash launches of the
    run."""
    from repro_torch.config import get_arch

    cfg = get_arch(WHISPER_ARCH)
    n = cfg.num_layers + cfg.num_encoder_layers
    attention_step_check(
        torch, dev, flash_mod, cfg, 2 * n, n,
        ("embed/tokens", "enc_layers/0/attn/wq", f"enc_layers/{cfg.num_encoder_layers - 1}/mlp/w1",
         "layers/0/attn/wk", f"layers/{cfg.num_layers - 1}/xattn/wv", "lm_head"),
        "whisper_train_check", seq=WHISPER_TEXT)
    torch.cuda.empty_cache()
    return train_cell(torch, dev, flash_mod, cfg, "whisper-train", WHISPER_BATCHES,
                      WHISPER_TRAIN_STEPS, (2 * n, n), seq=WHISPER_TEXT)


def train_internvl2(torch, dev, flash_mod) -> tuple:
    """Phase 13 (d): internvl2-2b, one AdamW step at full width and
    VLM_CHECK_LAYERS layers through the kernels against the
    plain-attention step (``vision_proj`` among the leaves held), then the
    cell internvl2-train-4k: the whole model, VLM_TRAIN_STEPS steps of
    ``vision_tokens`` patches + the rest of 4096 in text at the largest of
    TRAIN_BATCHES that fits.  Returns (batch, forward, backward) flash
    launches of the run."""
    from repro_torch.config import get_arch

    full = get_arch(VLM_ARCH)
    L, text = VLM_CHECK_LAYERS, TRAIN_SEQ - full.vision_tokens
    attention_step_check(
        torch, dev, flash_mod, full.replace(num_layers=L), 2 * L, L,
        ("embed/tokens", "vision_proj/w1", "layers/0/attn/wq", f"layers/{L - 1}/mlp/w2",
         "lm_head"), "internvl2_train_check", seq=text)
    torch.cuda.empty_cache()
    return train_cell(torch, dev, flash_mod, full, "internvl2-train-4k", TRAIN_BATCHES,
                      VLM_TRAIN_STEPS, (2 * full.num_layers, full.num_layers), seq=text)


def time_flash_train(torch, flash_mod, dev, shapes) -> list:
    """Flash's forward (the lse instance) and backward at the training
    shapes of phase 13 (label, B, H, KV, S, hd, causal), each beside
    SDPA's forward and its backward through autograd on the same inputs,
    by CUDA events as phase 8 times; the forward held to SDPA's output
    within FLASH_TOL.  Bounds: the visible pairs' FLOPs at the bf16
    tensor-core rate (the backward 2.5 times the forward's) against the
    bytes each must move."""
    import torch.nn.functional as F

    fa, rows = flash_mod.flash_attention, []
    counts = (fa.launches, fa.tc_launches, fa.bwd_launches, fa.bwd_tc_launches)
    for label, B, H, KV, S, hd, causal in shapes:
        g = torch.Generator(device=dev).manual_seed(SEED + S + hd)
        q, k, v, dout = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                         for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
        out, lse = flash_mod.flash_attention_fwd(q, k, v, causal=causal)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
        o = sdpa()
        ref = o.detach().float()
        err = float((out.float() - ref).abs().max() / ref.abs().max().clamp(min=1))
        if not err <= FLASH_TOL["bfloat16"]:
            fail(f"13: flash forward at {label}: max abs err {err} against SDPA")
        row = {"shape": label, "B": B, "H": H, "KV": KV, "S": S, "hd": hd, "causal": causal,
               "fwd_err_vs_sdpa": err,
               "fwd_ms": cuda_ms(torch, lambda i: flash_mod.flash_attention_fwd(
                   q, k, v, causal=causal)),
               "bwd_ms": cuda_ms(torch, lambda i: flash_mod.flash_attention_bwd(
                   q, k, v, out, lse, dout, causal=causal)),
               "sdpa_fwd_ms": cuda_ms(torch, lambda i: sdpa()),
               "sdpa_bwd_ms": cuda_ms(torch, lambda i: torch.autograd.grad(o, leaves, dout,
                                                                           retain_graph=True))}
        flops = 4 * hd * H * B * (S * (S + 1) // 2 if causal else S * S)
        fwd_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()     # q, out; k, v
        bwd_bytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()     # q out dout dq; k v dk dv
        for part, f, nbytes in (("fwd", flops, fwd_bytes), ("bwd", 2.5 * flops, bwd_bytes)):
            t_ops, t_bytes = 1e3 * f / BF16_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
            row[f"{part}_bound_ms"] = max(t_ops, t_bytes)
            row[f"{part}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            row[f"{part}_x_bound"] = row[f"{part}_ms"] / row[f"{part}_bound_ms"]
        rows.append(row)
        print(json.dumps({"phase": "flash_train_shape", **row, "card": card_line()}), flush=True)
        del q, k, v, dout, out, lse, leaves, o
        torch.cuda.empty_cache()
    fa.launches, fa.tc_launches, fa.bwd_launches, fa.bwd_tc_launches = counts
    return rows


def families_train_phase(torch, dev, flash_mod) -> tuple:
    """Phase 13: (a) the MoE kernel step against the plain step with the
    routing replayed, (b) moe-train-4k (and qwen3-moe), (c) whisper, (d)
    internvl2, then flash at their training shapes beside SDPA.  Returns
    the (forward, backward) flash launches of the four train runs."""
    import importlib

    from repro_torch.config import get_arch

    moe_mod = importlib.import_module("repro_torch.models.moe")
    t = time.perf_counter()
    moe_kernel_vs_plain(torch, dev, flash_mod, moe_mod)
    torch.cuda.empty_cache()
    moe_batch, moe_fwd, moe_bwd = train_moe(torch, dev, flash_mod, moe_mod)
    wh_batch, wh_fwd, wh_bwd = train_whisper(torch, dev, flash_mod)
    torch.cuda.empty_cache()
    vlm_batch, vlm_fwd, vlm_bwd = train_internvl2(torch, dev, flash_mod)
    torch.cuda.empty_cache()
    moe, vlm, wh = (get_arch(a) for a in (MOE_ARCH, VLM_ARCH, WHISPER_ARCH))
    time_flash_train(torch, flash_mod, dev, [
        (label, B, c.num_heads, c.num_kv_heads, S, c.head_dim, causal)
        for label, B, c, S, causal in (
            (MOE_ARCH, moe_batch, moe, TRAIN_SEQ, True), (VLM_ARCH, vlm_batch, vlm, TRAIN_SEQ, True),
            ("whisper_encoder", wh_batch, wh, wh.encoder_ctx, False),
            ("whisper_decoder", wh_batch, wh, WHISPER_TEXT, True))])
    print(json.dumps({"phase": "families_train_wall", "s": time.perf_counter() - t,
                      "card": card_line()}), flush=True)
    return moe_fwd + wh_fwd + vlm_fwd, moe_bwd + wh_bwd + vlm_bwd


# ---------------------------------------------------------------------------
# Phase 12: the model-side sharding on the (1, 1) mesh
# ---------------------------------------------------------------------------

def _same(torch, what: str, a, b) -> None:
    """Fail unless ``a`` equals ``b`` to the bit (trees of tensors)."""
    from repro_torch.utils.tree import tree_flatten_with_names

    fa, fb = dict(tree_flatten_with_names(a)), dict(tree_flatten_with_names(b))
    if fa.keys() != fb.keys():
        fail(f"phase 12 {what}: the trees differ")
    for name, x in fa.items():
        y = fb[name]
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            diff = (x.float() - y.float()).abs().max().item()
            fail(f"phase 12 {what}: {name or 'value'} differs from the unsharded path (max {diff})")
        if not isinstance(x, torch.Tensor) and x != y:
            fail(f"phase 12 {what}: {name} {x} != {y}")


def _local(tree):
    """A tree of DTensors on the (1, 1) mesh as its local tensors."""
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


def _timed_step(torch, fn, *args):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t), torch.cuda.max_memory_allocated() / 1e9


def model_sharded_phase(torch, dev, fix_mod, flash_mod, backend: str = "nccl") -> tuple:
    """Phase 12: h2o-danube-1.8b's sharded prefill, quantized decode and
    train step on the (1, 1) mesh, each equal to the unsharded path to the
    bit.  Returns the phase's (fixmatmul, flash forward, flash backward)
    launches."""
    import torch.distributed as dist

    from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, TrainConfig, get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train.train_step import make_train_step

    fa, fx = flash_mod.flash_attention, fix_mod.fixmatmul
    start = {"fix": fx.launches, "fwd": fa.launches, "bwd": fa.bwd_launches}
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    store_dir = os.path.join(HERE, "build", "phase12")
    shutil.rmtree(store_dir, ignore_errors=True)
    os.makedirs(store_dir)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh_cfg = MeshConfig(data=1, model=1)
        mesh = make_mesh(mesh_cfg, dev.type)
        cfg = get_arch(ARCH)
        L = cfg.num_layers
        g = torch.Generator(device=dev).manual_seed(SEED + 12)
        line = {"phase": "model_sharding", "arch": ARCH, "mesh": list(mesh_cfg.shape),
                "torch": torch.__version__}

        # (a) prefill
        run = RunConfig(model=cfg, mesh=mesh_cfg,
                        shape=ShapeConfig("prefill", MESH_PREFILL_LEN, 1, "prefill"))
        sf = steps.build_prefill(run, mesh)
        (params,) = sf.init(SEED)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, MESH_PREFILL_LEN), generator=g,
                                         device=dev, dtype=torch.int32)}
        model = build_model(cfg, dev)
        (ref, _), ref_ms, _ = _timed_step(torch, model.forward, params, batch)
        n = (fa.launches, fa.tc_launches)
        logits, first_ms, _ = _timed_step(torch, sf.fn, params, batch)
        if (fa.launches - n[0], fa.tc_launches - n[1]) != (L, L):
            fail(f"phase 12 (a): {fa.launches - n[0]} flash launches "
                 f"({fa.tc_launches - n[1]} on the tensor cores), expected {L}")
        _same(torch, "(a) logits", logits.to_local(), ref)
        del logits
        # the second call is the step; the first also propagates DTensor's shardings
        logits, ms, peak = _timed_step(torch, sf.fn, params, batch)
        _same(torch, "(a) logits again", logits.to_local(), ref)
        line["prefill"] = {"batch": 1, "seq": MESH_PREFILL_LEN, "first_ms": first_ms, "ms": ms,
                           "unsharded_ms": ref_ms, "tokens_per_s": MESH_PREFILL_LEN / ms * 1e3,
                           "peak_gb": peak}
        del sf, params, logits, ref, model
        torch.cuda.empty_cache()

        # (b) quantized decode against a full cache
        B, C, n_steps = MESH_DECODE
        qcfg = cfg.replace(quantized_serve=True)
        run = RunConfig(model=qcfg, mesh=mesh_cfg, shape=ShapeConfig("decode", C, B, "decode"))
        sf = steps.build_decode(run, mesh)
        qparams, cache = sf.init(SEED)
        _, per_step = decode_launches(qcfg, qparams)
        model = build_model(qcfg, dev)
        tokens = torch.randint(0, cfg.vocab_size, (B, n_steps), generator=g, device=dev,
                               dtype=torch.int32)
        # fn places a copy of the cache; the unsharded steps write the original
        ref_cache, shard_cache = cache, cache
        ms, ref_ms, peak = [], [], 0.0
        for i in range(n_steps):
            tok = tokens[:, i:i + 1]
            n = fx.launches
            (logits, shard_cache), t, p = _timed_step(torch, sf.fn, qparams, shard_cache, tok)
            if fx.launches - n != per_step:
                fail(f"phase 12 (b) step {i}: {fx.launches - n} fixmatmul launches, "
                     f"expected {per_step}")
            (ref, ref_cache), t_ref, _ = _timed_step(torch, model.decode_step, qparams, ref_cache,
                                                     tok)
            _same(torch, f"(b) step {i} logits", logits.to_local(), ref)
            ms.append(t)
            ref_ms.append(t_ref)
            peak = max(peak, p)
        _same(torch, "(b) cache", _local(shard_cache), ref_cache)
        line["decode"] = {"batch": B, "cache": C, "steps": n_steps, "quantized": True,
                          "step_ms": ms, "unsharded_step_ms": ref_ms,
                          "tokens_per_s_after_first": B * (n_steps - 1) / sum(ms[1:]) * 1e3,
                          "fixmatmul_per_step": per_step, "peak_gb": peak}
        del sf, qparams, cache, ref_cache, shard_cache, model
        torch.cuda.empty_cache()

        # (c) the train step
        B, S, n_steps = MESH_TRAIN
        tcfg = TrainConfig(total_steps=n_steps, warmup_steps=1)
        run = RunConfig(model=cfg, mesh=mesh_cfg, train=tcfg,
                        shape=ShapeConfig("train", S, B, "train"))
        sf = steps.build_train_step(run, mesh)
        (state,) = sf.init(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g, device=dev,
                               dtype=torch.int32)
        batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
        shard_state, ms, peak, losses = state, [], 0.0, []
        for i in range(n_steps):
            n = (fa.launches, fa.tc_launches, fa.bwd_launches)
            (shard_state, m), t, p = _timed_step(torch, sf.fn, shard_state, batch)
            got = (fa.launches - n[0], fa.tc_launches - n[1], fa.bwd_launches - n[2])
            if got != (2 * L, 2 * L, flash_mod.BWD_KERNELS * L):
                fail(f"phase 12 (c) step {i}: flash launches (fwd, tc, bwd) {got}, expected "
                     f"{(2 * L, 2 * L, flash_mod.BWD_KERNELS * L)}")
            ms.append(t)
            peak = max(peak, p)
            losses.append(m["loss"])
        shard_params = _local(shard_state.params)
        del shard_state
        step_fn = make_train_step(sf_model := build_model(cfg, dev), tcfg)
        ref_ms = []
        for i in range(n_steps):
            (state, m), t, _ = _timed_step(torch, step_fn, state, batch)
            _same(torch, f"(c) step {i} loss", losses[i], m["loss"])
            ref_ms.append(t)
        _same(torch, "(c) params", shard_params, state.params)
        line["train"] = {"batch": B, "seq": S, "steps": n_steps, "step_ms": ms,
                         "unsharded_step_ms": ref_ms,
                         "tokens_per_s_after_first": B * S * (n_steps - 1) / sum(ms[1:]) * 1e3,
                         "losses": [float(x) for x in losses], "peak_gb": peak}
        del sf, state, shard_params, step_fn, sf_model
        line["card"] = card_line()
        print(json.dumps(line), flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    return (fx.launches - start["fix"], fa.launches - start["fwd"], fa.bwd_launches - start["bwd"])


if __name__ == "__main__":
    sys.exit(main())
