#!/usr/bin/env python3
"""GPU smoke run of snngp_torch on one NVIDIA card: exact-GP serving and
ML-II training, sparse variational classification of images with the CNN,
the WideResNet and the Myrtle NNGP, the Myrtle Gram -> Cholesky ->
Student-t pipeline, the memory-lean fit, the device mesh of exact-GP
regression and of classification and the pipeline, the finite-width
ensemble and the paper figures.

    python3 chip_smoke.py

Phases, each printing what it found; any failed check raises and the
script exits non-zero:

0. setup: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions, and the build of the CUDA kernels from ``snngp_torch/csrc``
   (one ``nvcc`` per source, started together) with ``nvcc``'s register /
   shared-memory / spill report;
1. the fused Gram kernel (K1) against its plain PyTorch version on the same
   inputs, mlp / resnet x relu / erf at depth 4, at the headline shape
   (10,000 x 16 against itself, a symmetric launch, ``same=True``), a
   ragged cross shape and a shape whose feature dim exceeds the kernel's
   staging chunk; gate: relative error max|K_kernel - K_plain| /
   max|K_plain| <= 1e-5, a second launch bitwise equal, and K(x, x)
   bitwise symmetric;
2. serving at size: fit_spr + four 1,000-point requests of FittedSPR.predict
   on a depth-4 ReLU MLP NNGP with a Student-t likelihood, N = 10,000, D = 16,
   against the plain fp32 tier and the plain float64 tier on the card;
3. the serving CLI: ``python -m snngp_torch reg ts`` / ``reg pr`` on a
   checkpoint written in the JAX package's format, on CUDA and on the CPU;
4. the Gram's scalar-tangent backward kernel (K2) against its plain version
   at phase 1's shapes and variants (K(x, x) a symmetric launch, which
   weights each pair j < i by g[i, j] + g[j, i]), on a random cotangent,
   which is not symmetric, and, at 10,000 x 16, on the cotangent of the
   ML-II loss; gate: for each of the three sums, |s_kernel - s_plain| /
   sum |g dK| <= 1e-5, and a second launch bitwise equal;
5. ML-II training at size, same model and data as phase 2 with eps = 1e-2
   absolute: one loss and gradient through the kernels (K1 forward, K2
   backward) against float64 autograd through the plain layer tier on the
   card (gate: within 2x the plain fp32 tier's error), then
   ``SNNGPRegressor(max_steps=10).fit`` (finite, decreasing losses, one K1
   and one K2 launch per step, a per-phase step breakdown), a 1,000-point
   ``predict``, five more steps timed one by one and a ``torch.profiler``
   profile of one step;
6. the training CLI: ``reg tr`` on CUDA, ``reg ts`` on its checkpoint,
   ``reg tr -rs`` resuming it, and the same training on the CPU; the best
   NLLs of CUDA and CPU agree;
7. the fused CNN Gram kernel (K3) against its plain version: the three
   Gram blocks of an SVSP step at 32 x 32 x 3 (100 x 200, 200 x 200 and
   100 x 100), relu / erf on distinct and on identical operands (the
   latter a symmetric launch, ``same=True``), 28 x 28 x 1, 8 x 8 x 1, an
   8 x 100 image (wider than 32: streamed transposed), depths 1 and 10;
   gate: relative error <= 1e-5 of max|K|, a second launch bitwise equal,
   and K(x, x) bitwise symmetric;
8. its scalar-tangent backward (K4) against its plain version at phase 7's
   cases on a random, not symmetric cotangent, identical operands a
   symmetric launch (gate: each sum within 1e-5 of sum |g dK|, bitwise
   equal over two launches), and one scalar-only gradient through
   ``get_cnn_kernel(trainable_inputs=False)`` against float64 autograd
   through the plain layer tier;
9. SVSP at full width: synthetic32 (32 x 32 x 3), 200 inducing images,
   batches of 100, depth 4 relu; the ELBO's gradient on one batch against
   float64 on the card for svgp and svtp (gate: within 2x the plain fp32
   path's error), then 10 timed ELBO steps each of svgp, svtp and svtp
   with frozen inducing inputs, split into gram / posterior /
   sampling+likelihood / backward / optimizer, with the peak memory
   (gate: finite losses, three K3 launches a step, three K4 a step when
   frozen);
10. the classification CLI: ``cls tr -m svtp -dn synthetic32 -e 1`` at
   those sizes (and again with ``--freeze-inducing``), ``cls ts`` on its
   checkpoint on CUDA and on the CPU (gate: within a Monte Carlo tolerance
   derived from the card's draws), ``cls pr``, and one timed
   ``FittedSVSP`` request of 100 images at 10,000 samples;
11. the WideResNet kernels against their plain versions: the residual tail
   (K5) on the three Gram blocks of an SVSP step at 32 x 32 x 3 (four blocks,
   the first with a conv shortcut; K(x, x) a symmetric launch), three
   blocks at 16 x 16, 8 x 8 and 4 x 4, erf, a ragged 7 x 7, a 5 x 64
   state (wider than 32: streamed transposed); the stride-2 block (K6) at
   32 -> 16, 16 -> 8, 8 -> 4, 7 x 7, 6 x 10 and 5 x 64 (transposed); K(x,
   x) a symmetric launch of either; gate: relative error <= 1e-5 of
   max|K|, a second launch bitwise equal, and K(x, x) bitwise symmetric;
12. WideResNet SVSP at full width (the CIFAR shape of phase 9, ``-n
   resnet``): the svgp ELBO's gradient on one batch against float64 on the
   card through the plain layer tier (gate: within 2x the plain fp32
   path's error), then 10 timed svgp ELBO steps and 10 with frozen inducing
   inputs, split by phase, with the peak memory (gate: finite losses, 12 K5
   and 9 K6 launches a step), then one profiled step of each;
13. the WideResNet classification CLI: ``cls tr -n resnet -m svtp -dn
   synthetic32 -e 1`` at the defaults on the card, ``cls ts`` on the card
   and on the CPU (gate: within the Monte Carlo tolerance), ``cls pr``;
14. the fused Myrtle Gram (K7) and its scale-tangent mode against their
   plain versions: Myrtle-5/7/10 x relu / erf at 8 x 8, 16 x 16 and 32 x 32
   (rectangular and ragged, or symmetric), the tangent modes w, b and wb
   (wb only at 32 x 32), a ragged symmetric wb case at 16 x 16 in erf and
   in relu; gate: error <= 1e-5 of max|K| (of max|dK| per tangent; the
   relu symmetric case at 16 x 16, whose same-image pairs meet c = 1: its
   error against float64 within 2x the plain fp32 version's), two launches
   bitwise equal, every symmetric launch (``same``, both modes) bitwise
   symmetric in K and its tangents; both timed (one call each) at 200 x
   200 pairs of 32 x 32 x 3, Myrtle-5, relu, beside their plain versions,
   their bounds and the bound's share of the kernel's time; then K7's bf16
   pair-state variant (``myrtle_gram_cuda(state=torch.bfloat16)``) at
   Myrtle-5 (rectangular) and Myrtle-7 (ragged symmetric) x relu / erf at
   8 x 8 and 16 x 16 and at the head shape (gate: within 1e-4 of max|K| of
   its bf16 plain version on the card; its distance from the fp32 kernel
   within [0.5x, 2x] the plain bf16 version's, the upper side floored at
   1e-3; finite; two launches
   bitwise equal; symmetric launches bitwise symmetric), with the bf16 and
   fp32 forwards timed in turns at the head shape and the bf16 plain
   version once;
15. Myrtle SVSP at full width (synthetic32, 200 frozen inducing images,
   batches of 100, Myrtle-5 relu): the ELBO's gradient against float64
   through K7's plain versions at 20 inducing images and batch 10 (gate:
   within 2x the plain fp32 path's error; svgp), then 1 timed step each of
   svgp and svtp, split by phase, with the peak memory (gate: finite
   losses, 3 K7 and 3 K7 tangent launches a step);
16. ``cls tr -n myrtle -nh 5 -m svtp -dn synthetic32 -e 1`` (300 images, 20
   inducing) on the card, ``cls ts`` on the card and on the CPU (gate:
   within the Monte Carlo tolerance), ``cls pr``;
17. the pipeline, ``python -m snngp_torch.examples.cifar_myrtle --device
   cuda --image-size 32 --depth 5 --n-train 512 --n-test 128 --fused on
   --mlii 3 --mlii-n 128`` on seeded synthetic images: its per-phase
   report and a finite NLL, launching K7 only; then the same sizes with
   ``--bf16 --t-jitter 1e-2`` and no ML-II (gate: a finite NLL, bf16 in
   effect, 3 launches of K7's bf16 variant and none of the fp32 kernel);
   then K7 against the full tier on a 64-image block (gate: 2e-5 of
   max|K|);
18. extendable serving at phase 2's size: ``fit_spr(extendable=True)``,
   then ``FittedSPR.extend`` by 1,000 points; its predictive on a
   1,000-point request against a float64 factorization of the same
   bordered matrix (gate: within 2x a fresh fp32 fit's error), extend
   against refit times, and save / load / extend again (gate: bitwise equal
   to the in-memory result);
19. ``reg fd`` on syn-normal over a 2 x 2 x 3 grid on the card and on the
   CPU (gate: the best Student-t and Gaussian NLLs within rtol 5e-3), then
   ``reg pr --add-x / --add-y`` on phase 3's checkpoint and cache;
20. ``SNNGPClassifier(network="mlp")`` on a seeded 300 x 64 tabular set, 3
   classes, one epoch, ``predict_proba`` (gate: finite losses);
21. full-Gram ML-II on its main path: ``cifar_myrtle --mlii 2 --mlii-scope
   full`` at N = 256 (gate: a finite NLL; the ML-II time a step); then,
   after the Myrtle window, ``full_gram_mlii_value_and_grad`` on
   ``tiled_aug_gram`` of 160 seeded standard-normal 32 x 32 x 3 images at
   block 64 (K7's tangent mode, a symmetric launch on each diagonal tile)
   against autograd of ``SPR.loss`` through
   ``get_myrtle_kernel(trainable_inputs=False)``, gp and tp (gate: loss
   rtol 1e-5, gradients rtol 2e-3, atol 1e-6), and against float64
   arithmetic on its own tiles (the same gate); on 160 of the pipeline's
   uniform images, the same, plus the float64 witnesses, the closed form
   on K7's plain float64 tangent tiles against autograd through K7's plain
   versions in float64 (gate: rtol 1e-6), with each fp32 route's error
   against them printed; and the peak device memory of one
   ``full_gram_mlii_value_and_grad`` at N = 8,192 (gate: below 1.5 x S's
   bytes, the factor written over S);
22. the finite-width ensemble: ``ens tr -m tp -dn synthetic32 -nh 4 -nc 32
   -nb 250 -e 2`` (the JAX CLI's default widths) with ``-mp highest`` and
   ``-mp default``, each epoch's seconds, the valid NLL and accuracy (gate:
   finite; both TF32 flags off again afterwards); ``ens ts`` of the two
   members on the card and on the CPU (gate: test NLLs within rtol 1e-4 at
   ``highest``);
23. the paper figures, ``python -m snngp_torch.examples.paper_figures``
   at the notebook's sizes (width 512, 500 members in one batch, 10,000
   SGD steps): each panel's seconds and KS statistic (gate: initial <=
   0.0607, the 5% critical value at n = 500; last and full <= 0.12); then 8
   members from one host-drawn init after 200 full-train steps on the card
   and on the CPU, in float32 and float64 (gate: float32 within 1e-4 of
   max |f|, float64 within 1e-10);
24. the memory-lean fit, ``fit_spr(memory_lean=True)``: at phase 2's size
   against phase 2's float64 requests (gate: within 2x the default fp32
   fit's error); at N = 110,000, D = 16 (phase 2's model; first K1's
   symmetric launch there, 1.2e10 outputs, against its plain version on 64
   rows, gate 1e-5, before the window): its peak device memory (gate: <=
   1.10 x 4 N^2 bytes), the float64 backward error of alpha from K1 row
   panels (gate: <= 1e-5), one 1,000-point request from the upper factor
   (gate: peak above the factor <= 10% of its bytes) and the
   Weinstein-Aronszajn witness of ``inplace_blocked_cholesky`` (K = I + X
   X^T / 128, gate: logdet rtol 1e-4);
25. the mesh of exact-GP regression, four shards of ``cuda:0`` (and 2 x 2):
   ``sharded_gram`` at N = 32,768, D = 64 against the single-device K1 Gram
   (gate: 1e-5 of max|K|), ``cyclic_cholesky`` and ``distributed_cholesky``
   against cuSOLVER's factor (gates: 1e-5 of max|L|, a float64 backward
   error max|L L^T - S| within 2x cuSOLVER's own, logdet rtol 1e-8), ``python -m
   snngp_torch.examples.mesh_pipeline`` at N = 32,768 (its parity gate
   against one device), ``SPR.loss``'s gradients on the mesh at phase 5's
   size (gate: within 2x the single-device fp32 error against float64) and
   ``distributed_mlii_value_and_grad`` at 256 images through K7's tangent
   mode against ``full_gram_mlii_value_and_grad`` and against float64 on
   its own row panels (gate: loss rtol 1e-5, gradients rtol 2e-3, atol
   1e-6). The shards run one after another: these times are not a
   multi-card time;
26. the batch-sharded ELBO (``SVSP.loss(..., mesh=)``: k_bi and k_bb as row
   panels over the shards, k_ii on the lead device) at phases 9, 12 and 15's
   shapes: its gradient on one batch against their float64 references
   (CNN svgp / svtp and WideResNet svgp on four shards of ``cuda:0``,
   Myrtle-5 svgp at batch 10 on two; gate: within 2x the single-device
   fp32 kernel path's error), then 5 timed steps each of CNN svgp, CNN svtp
   with frozen inducing inputs, WideResNet svgp and Myrtle-5 svtp on four
   shards beside the single-device steps (gates: finite losses; exactly 9
   K3 a step (and 9 K4 when frozen), 36 K5 and 27 K6, or 9 K7 and 9 K7
   tangent passes);
27. ``cls tr -m svtp -dn synthetic32 -e 1`` at phase 10's sizes through
   ``train_main(args, mesh=...)`` on four shards, then ``cls ts`` of its
   checkpoint on one device (gates: the log's ``Mesh: 4 devices
   (batch-sharded ELBO)`` and finite nELBOs; the NLL within phase 10's Monte
   Carlo tolerance of phase 10's);
28. ``cifar_myrtle --fused on`` at phase 17's sizes without ML-II, with the
   four shards handed in (``main(argv, mesh=)``): after the window its
   gathered Grams against the single-device ones (gate: 1e-5 of max|K|)
   and its NLL within 1e-4 of the same command on one device, or else each
   route's NLL against a float64 fit of its own Grams, the mesh route's
   error within 2x the single-device route's (it prints which gate held);
29. ``python -m snngp_torch -f 0.05`` and ``--fraction=0.5`` with a
   ``reg tr`` of phase 6's flags in a process of their own: each command
   completes (gate: finite NLLs), an allocation above the cap raises
   out-of-memory and one below it does not (gate);
30. ``snngp_torch.utils.profiling.trace`` around one K1 launch, right
   after phase 1 (gate: the Chrome trace it writes names ``gram_kernel``
   and ``trace`` does not warn) and again after phase 29, where
   torch.profiler can lose a capture's kernel records (gate: the trace
   names ``gram_kernel`` or ``trace`` warned that it lacks kernels);
31. the mesh across processes, after phase 29: ``python -m
   torch.distributed.run --standalone`` runs ``snngp_torch/tools/dist_mesh.py``
   on 2 gloo ranks, both on ``cuda:0`` (``init_distributed``, a mesh of one
   shard a rank): ``sharded_gram`` and the cyclic and row-panel
   factorizations at phase 25's N = 32,768, ``SPR.loss`` and its gradients
   at N = 10,000, the distributed ML-II step at 256 images and one CNN ELBO
   and its gradients at the CIFAR shape (gates: the Grams and the factors
   bit for bit against the one-process mesh of 2 shards on the card, q and
   logdet S bit for bit and the six ML-II sums within 1e-12 relative of it,
   the losses bit for bit, the gradients within 2x the single-device fp32
   error against phases 5's and 9's float64 references, every rank's
   results equal to rank 0's, and K1, K2, K3 and K7's tangent mode launched
   by the ranks); then the same parts on one NCCL rank (the same gates), and
   two NCCL ranks on ``cuda:0`` once, whose outcome is printed, not gated
   (NCCL refuses two ranks on one card). A rank that fails fails the phase,
   and a group that outlives DIST_TIMEOUT is killed. The ranks share one
   card: their times are not a multi-card time.

Nine main paths run with the kernels' launch counts set to 0 just before
and read just after: serving (phases 2-3), training (phases 5-6), the
regression extras (phases 18-20; K1 and no other kernel), CNN
classification (phases 9-10), WideResNet classification (phases 12-13),
Myrtle classification with the pipeline, its bf16 run and full-Gram ML-II
(phases 15-17 and 21's pipeline; K7, its tangent mode and its bf16
variant), the lean and mesh regression (phases 24-25: K1,
K2 and K7's tangent mode), classification and the pipeline on the mesh
(phases 26-28: K3-K7 and K7's tangent mode, no K1 or K2), the mesh across
processes (phase 31, counted in each rank: K1, K2, K3 and K7's tangent
mode) and the ensemble
with the figures (phases 22-23,
which run cuDNN convolutions and cuBLAS products: none of K1-K7 may
launch there); each fails if a kernel of its path never launched. Launches made to compare a kernel with its plain version or
with autograd (phases 1, 4, 7, 8, 11 and 14, the gradient checks of
phases 9, 12 and 15, run just before their windows, and phase 17's
full-tier comparison and phase 21's gradient check, run just after the
Myrtle window, the references of phases 24-25 and 28, run before their
windows, and phase 28's comparisons, run after its window) are not
counted.
Each phase prints its seconds. The line before the last is one JSON object
describing the kernels (K1-K7, K7's tangent mode and its bf16 variant);
the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when CUDA is not available or the
``snngp_torch`` package is not beside this script. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import runpy
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEPTH = 4
W_STD, B_STD, LAST_W_STD = 1.3, 0.3, 1.0
KERNEL_REL_TOL = 1e-5      # bench.py's _pallas_parity bar for the TPU kernels
# K2's sums against the plain version's, relative to sum |g dK| (the scale of
# the terms the sum cancels): the same 1e-5 bar.
K2_REL_TOL = 1e-5
K2_DEEP = 128              # K2's deep case: 16 passes of staged row factors
SHAPES = {"10000x16 sym": (10_000, None, 16),
          "1001x7 vs 333x7": (1_001, 333, 7),
          "512x100 sym": (512, None, 100)}
HEAD_SHAPE = "10000x16 sym"
# H100 SXM peaks (NVIDIA's data sheet).
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
H100_FP64_PER_S = 34e12
# Packed bf16 add / mul / FMA on the CUDA cores: 256 results a clock an SM,
# twice fp32's 128 (the CUDA C++ Programming Guide's arithmetic throughput
# table, compute capability 9.0), so twice the fp32 peak.
H100_BF16_PER_S = 2 * H100_FP32_PER_S
SERVE_N, SERVE_D = 10_000, 16
REQUESTS, REQUEST_SIZE, PREDICT_BATCH = 4, 1_000, 4096
SERVE_EPS = 1e-3           # relative diag_reg of the main factorization
SERVE_T_JITTER = 1e-4      # absolute jitter of the Student-t scale factorization
TRAIN_EPS = 1e-2           # absolute eps of the ML-II loss (K + eps I)
TRAIN_STEPS = 10
SVSP_DEPTH = 4             # cls tr -nh's default
SVSP_NI, SVSP_NB = 200, 100  # cls tr -ni, -nb defaults
SVSP_SAMPLES = 100         # cls tr -ns default
SVSP_STEPS = 10
CLS_TEST_N = 300           # test images of the cls ts comparison
K34_HEAD = "relu/200x200 32x32x3 sym"   # K(Z, Z) of one SVSP step
K5_HEAD = "relu/200x200 32x32 4 blocks+sc sym"   # group 1 of K(Z, Z)
K6_HEAD = "relu/200x200 32->16 sym"              # group 2's stride-2 block of K(Z, Z)
RESNET_TEST_N = 100        # test images of the resnet cls ts comparison
MYRTLE_DEPTH = 5           # Myrtle-5: one conv per pooling group
MYRTLE_STEPS = 1           # timed Myrtle ELBO steps of each method (~10 s each)
# The float64 gradient check of the Myrtle SVSP at a reduced pair count: a
# float64 pair state at full batch would be ~160 GB through the full tier,
# and the plain versions at 32 x 32 are launch-bound (~2 s a Gram block).
MYRTLE_CHECK_NI, MYRTLE_CHECK_NB = 20, 10
# cls tr -n myrtle: 300 images (6 steps of 50), 20 inducing images, so that
# cls ts on the CPU (K7's plain version at 32 x 32, a Python loop over
# ~5,000 slabs a Gram block) stays within ~30 s.
MYRTLE_CLI = ["-nd", "300", "-ni", "20", "-nb", "50"]
MYRTLE_TEST_N = 20         # test images of the myrtle cls ts comparison
# The pipeline at N = 512 / 128 (ML-II on 128): at 1,024 / 256 (ML-II on
# 256) it took 56 s on an H100 (PERF.md), and the smoke aims at ~300 s.
PIPELINE = ["--image-size", "32", "--depth", "5", "--n-train", "512", "--n-test", "128",
            "--fused", "on", "--mlii", "3", "--mlii-n", "128"]
CLI_RTOL = 5e-3            # CUDA vs CPU CLI NLL (tests/test_cli_smoke.py:47-51)
# Student-t (a, b) of the CLI runs. syn-t's Gram is near rank-1 (1-D
# inputs); at b/a = 1 the reference's hardcoded 1e-6 jitter on (b/a) K cannot
# absorb its fp32 rounding, and both packages log NLL nan. b/a = 0.01 keeps
# that factorization PD in both, and on syn-normal keeps the predictive NLL
# of either package within 1e-3 of the other's.
CLI_A, CLI_B = 2.0, 0.02
CLI_TRAIN = ["-m", "tp", "-a", str(CLI_A), "-b", str(CLI_B), "-dn", "syn-normal",
             "-vi", "10", "-pi", "10", "-nh", "2", "-eps", "1e-2", "-q"]
EXTEND_M = 1_000           # points phase 18 adds to phase 2's fit
EXTEND_T_JITTER = 1e-6     # the Student-t jitter extend puts on the new block (as JAX)
# reg fd's grid of phase 19: 2 x 2 x 3 Grams' cells, a 2 x 2 (alpha, beta)
# lattice of 1,000 Burr-XII draws each.
FD_GRID = ["-dn", "syn-normal", "-wsl", "1", "1.4", "-bsl", "0", "0.3", "-el", "1e-2", "1e-1",
           "1", "-al", "1", "2", "-bl", "1", "2", "-ns", "1000", "-q"]
MLP_CLS_N, MLP_CLS_D = 300, 64     # phase 20's seeded tabular set, 3 classes
# Phase 21: full-Gram ML-II at 32 x 32 x 3, blocks of 64 over 160 images
# (three diagonal tiles, three off-diagonal, the last block ragged), against
# autograd of SPR.loss; tolerances of tests/test_mlii.py:107-119.
MLII_N, MLII_BLOCK, MLII_EPS, MLII_AB = 160, 64, 1e-2, (2.0, 1.5)
# The factorization's peak memory is read at a size where S (256 MiB) is
# far above the allocator's rounding and the panels (3 x 16 MiB).
MLII_MEM_N, MLII_MEM_PANEL = 8192, 512
MLII_HYPER = dict(w_std=1.0, b_std=0.1, last_w_std=1.0)   # the pipeline's initial scales
MLII_PIPELINE = ["--image-size", "32", "--depth", "5", "--n-train", "256", "--n-test", "64",
                 "--fused", "on", "--fused-block", "128", "--mlii", "2", "--mlii-scope",
                 "full"]
# Phase 22: ens tr at the JAX CLI's default widths (depth 4, 32 channels,
# batch 250) on synthetic32, two epochs, at both -mp settings; ens ts of the
# two members on the card and on the CPU.
ENS_TRAIN = ["ens", "tr", "-m", "tp", "-dn", "synthetic32", "-nh", "4", "-nc", "32",
             "-nb", "250", "-e", "2", "-q"]
ENS_TEST_N = 500
ENS_RTOL = 1e-4           # card against CPU, test NLL and averaged logits
# Phase 23: the paper figures at the notebook's sizes (width 512, 500
# members, 10,000 SGD steps at lr 1e-3), every member in one batch. The 5%
# critical value of the one-sample KS statistic at n = 500 is 1.358 /
# sqrt(500) = 0.0607; the trained panels carry an O(1/width) bias at width
# 512 (RESULTS.md: 0.0815 and 0.0831 in the JAX package), and a wrong mean
# or covariance lands far past 0.12.
FIGURES = ["--device", "cuda", "--ensemble-size", "500", "--train-steps", "10000",
           "--map-batch", "500"]
KS_INITIAL_MAX, KS_TRAINED_MAX = 0.0607, 0.12
# Eight fully trained members from one host-drawn init, 200 steps, on the card
# and on the CPU, in float32 and in float64.
FIG_CHECK_MEMBERS, FIG_CHECK_STEPS, FIG_CHECK_SEED = 8, 200, 10
# Phase 24: the memory-lean fit at N = 110,000 (phase 2's model; a 48.4 GB
# fp32 Gram, the size past which the default fit's ~4 N^2 bytes leave an
# 80 GB card), its peak device memory against 4 N^2 bytes, the float64
# backward error of alpha from K1 row panels, one request from the upper
# factor, and the Weinstein-Aronszajn witness K = I + X X^T / r at the same N,
# whose logdet is an [r, r] float64 computation.
LEAN_N, LEAN_ROWS, LEAN_PANEL = 110_000, 64, 1024
LEAN_PEAK = 1.10           # x 4 N^2 bytes
LEAN_BACKWARD = 1e-5       # backward error of alpha (n u = 6.6e-3 at N = 110,000)
WA_R, WA_RTOL = 128, 1e-4
# Phase 25: four shards of cuda:0 (and 2 x 2): the sharded Gram and the
# factorizations at N = 32,768, D = 64 (the mesh pipeline's 8 x 8 images),
# S = K + 10 I (the pipeline's eps, condition number ~1e3, where two fp32
# factorization orders stay within its mean / NLL parity bars), then
# SPR.loss at phase 5's size and full-Gram ML-II at 256 images.
MESH_SHARDS, MESH_N, MESH_D, MESH_EPS, MESH_BLOCK = 4, 32_768, 64, 10.0, 2048
MESH_LOGDET_RTOL = 1e-8
MESH_FACTOR_RTOL = 1e-5   # max|L_mesh - L_cuSOLVER| / max|L_cuSOLVER|
MESH_BACKWARD_X = 2.0     # max|L L^T - S| of a mesh factor, over cuSOLVER's own
MESH_PIPELINE = ["--devices", str(MESH_SHARDS), "--n-train", str(MESH_N), "--n-test", "256",
                 "--image-size", "8", "--eps", str(MESH_EPS)]
MESH_MLII_N = 256         # full-Gram ML-II on the mesh: standard-normal images
# Phases 26-28: classification and the pipeline on four shards of cuda:0. The
# ELBO at the CIFAR shape of phases 9, 12 and 15 (Myrtle's float64 reference
# is at batch 10: two shards), timed over MESH_ELBO_STEPS steps; cls tr at
# phase 10's sizes; the pipeline at phase 17's sizes without ML-II (phase
# 17's NLL is at its fitted scales, so a one-device run is the reference).
MESH_ELBO_STEPS = 5
MESH_MYRTLE_SHARDS = 2
MESH_CLS_N, MESH_CLS_TEST = 512, 128
MESH_CLS_PIPELINE = ["--image-size", "32", "--depth", "5", "--n-train", str(MESH_CLS_N),
                     "--n-test", str(MESH_CLS_TEST), "--fused", "on"]
PIPELINE_RTOL = 1e-4      # the mesh example's parity bar
# Phase 31: the mesh across processes under torchrun (2 gloo ranks on cuda:0,
# one NCCL rank, and once two NCCL ranks on cuda:0, not gated).
DIST_RANKS = 2
DIST_TIMEOUT = 300        # seconds a group may take before it is killed
DIST_KERNELS = ("gram", "gram_grads", "conv_gram", "myrtle_grads")


def _sync():
    import torch
    torch.cuda.synchronize()


def _time_ms(fn, reps=5):
    """Mean device time of fn() over reps calls, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _counters():
    from snngp_torch.ops import conv_gram as CG
    from snngp_torch.ops import gram as G
    from snngp_torch.ops import myrtle_gram as MG
    from snngp_torch.ops import resnet_conv_gram as RG
    return (G.LAUNCHES, CG.LAUNCHES, RG.LAUNCHES, MG.LAUNCHES)


def _launches():
    return {name: n for counter in _counters() for name, n in counter.items()}


def _reset_launches():
    for counter in _counters():
        for name in counter:
            counter[name] = 0


def _read_launches(path, kernels):
    """The counts since _reset_launches; fails if a kernel of the path never
    launched."""
    counts = _launches()
    print(f"[{path}] main-path launches {counts}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"the {path} path never launched kernel {name!r}")
    return counts


def card():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def phase0_setup():
    import torch
    from snngp_torch.ops import _build

    name_and_limit = card()
    print(name_and_limit)
    print(f"[setup] torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    # One nvcc per source, all started together.
    sources = ("gram", "conv_gram", "resnet_conv_gram", "myrtle_gram")
    built = {name: _build.library_path(name).exists() for name in sources}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for _ in pool.map(_build.load, sources):
            pass
    build_s = time.perf_counter() - t0
    for name in sources:
        print(f"[setup] {name}.cu {'loaded (cached build)' if built[name] else 'built'}; "
              f"all builds {build_s:.2f} s")
        for line in _build.ptxas_report(name):
            print(f"[setup] ptxas {name}: {line}")
    return name_and_limit


def phase1_kernel_vs_plain():
    import torch
    from snngp_torch.ops import gram as G

    rng = np.random.RandomState(0)
    rows = {}
    worst_abs = 0.0
    for shape_name, (n1, n2, d) in SHAPES.items():
        x1 = torch.as_tensor(rng.randn(n1, d).astype(np.float32), device="cuda")
        x2 = x1 if n2 is None else torch.as_tensor(
            rng.randn(n2, d).astype(np.float32), device="cuda")
        for mode in ("mlp", "resnet"):
            stack = G.mlp_var_stack if mode == "mlp" else G.resnet_var_stack
            for act in ("relu", "erf"):
                w, b, last = (torch.tensor(v, device="cuda") for v in (W_STD, B_STD, LAST_W_STD))
                v1s = stack(x1, DEPTH, act, w, b).contiguous()
                v2s = v1s if x2 is x1 else stack(x2, DEPTH, act, w, b).contiguous()
                scales = torch.stack([w * w, b * b, last * last,
                                      torch.tensor(1.0 / d, device="cuda")])
                args = (x1, x2, v1s, v2s, scales)
                kw = dict(depth=DEPTH, act=act, mode=mode)
                same = x2 is x1
                k_kernel = G.gram_cuda(*args, **kw, same=same)
                repeat = torch.equal(k_kernel, G.gram_cuda(*args, **kw, same=same))
                k_plain = G.gram_plain(*args, **kw)
                _sync()
                abs_err = (k_kernel - k_plain).abs().max().item()
                rel_err = abs_err / k_plain.abs().max().item()
                finite = bool(torch.isfinite(k_kernel).all())
                ms = _time_ms(lambda: G.gram_cuda(*args, **kw, same=same))
                plain_ms = _time_ms(lambda: G.gram_plain(*args, **kw))
                symmetric = torch.equal(k_kernel, k_kernel.T) if same else True
                print(f"[K1] {mode:6s} {act:4s} {shape_name:16s} rel_err {rel_err:.3e} "
                      f"abs_err {abs_err:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
                      f"  repeat bitwise {repeat}"
                      + (f"  bitwise symmetric {symmetric}" if same else ""))
                if not finite or not rel_err <= KERNEL_REL_TOL or not repeat or not symmetric:
                    raise AssertionError(
                        f"K1 {mode}/{act} at {shape_name}: rel_err {rel_err:.3e} "
                        f"(tol {KERNEL_REL_TOL}), finite={finite}, repeat={repeat}, "
                        f"symmetric={symmetric}")
                worst_abs = max(worst_abs, abs_err)
                nbytes = _read_bytes(args)
                bound, by = bound_ms(nbytes + n1 * x2.shape[0] * 4,
                                     k1_ops(n1, x2.shape[0], d, DEPTH, act, mode, same))
                rows[f"{mode}/{act}/{shape_name}"] = dict(
                    ms=ms, plain_ms=plain_ms, rel_err=rel_err, abs_err=abs_err,
                    bound_ms=bound, bound_by=by)
                del k_kernel, k_plain
    torch.cuda.empty_cache()
    return rows, worst_abs


# -- bounds ---------------------------------------------------------------------

def _dual_act_ops(act, partials):
    """fp32 operations of one dual activation (or of its partials with the
    tangents' sums T_v1 dv1 + T_v2 dv2, as K2 computes them), counted from
    csrc/gram.cu: an FMA is 2, every other arithmetic op, min/max, compare
    and select is 1, and acosf, asinf, sqrtf, rsqrtf and an IEEE divide
    count 1 each (on the card each is a multi-instruction sequence, so the
    count is a floor and the bound a least time). The per-row factors are
    O(N depth) and not counted."""
    if act == "relu":
        return 25 if partials else 15
    return 24 if partials else 7


def _pairs(n1, n2, same):
    """Pairs of images the function needs: n (n + 1) / 2 for K(x, x), whose
    lower triangle mirrors its upper one (K3-K7 run only those), else
    n1 n2."""
    return n1 * (n1 + 1) // 2 if same else n1 * n2


def _read_bytes(tensors):
    """Bytes of ``tensors`` read once each: views of one storage (K(x, x)'s
    second operand) count once."""
    seen = {(t.data_ptr(), t.numel()): t for t in tensors}
    return sum(t.numel() * t.element_size() for t in seen.values())


def k1_ops(n1, n2, d, depth, act, mode, same):
    """fp32 operations of K1 on these shapes (see _dual_act_ops)."""
    a = _dual_act_ops(act, False)
    per = 2 * d + 1 + (depth * (2 + a) + 1 if mode == "mlp"
                       else 2 + depth * (a + 3) + a + 1)
    return _pairs(n1, n2, same) * per


def k2_ops(n1, n2, d, depth, act, mode, same):
    """(fp32, fp64) operations of K2 on these shapes (see _dual_act_ops);
    the fp64 ones are the contraction's three FMAs per pair and, for
    K(x, x), the sum g[i, j] + g[j, i] of each pair j < i."""
    p = _dual_act_ops(act, True)
    per = 2 * d + 1 + (depth * (11 + p) + 3 if mode == "mlp"
                       else 3 + depth * (p + 14) + p + 7)
    folds = n1 * (n1 - 1) // 2 if same else 0
    return _pairs(n1, n2, same) * per, _pairs(n1, n2, same) * 6 + folds


def bound_ms(nbytes, fp32_ops, fp64_ops=0, bf16_ops=0):
    """Least time on an H100 SXM: the larger of the bytes over 3.35 TB/s and
    the operations over 67 TFLOP/s fp32 (34 TFLOP/s fp64, 134 TFLOP/s
    packed bf16 on the CUDA cores); and which bounds."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (fp32_ops / H100_FP32_PER_S + fp64_ops / H100_FP64_PER_S
             + bf16_ops / H100_BF16_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- K2 -------------------------------------------------------------------------

def _k2_inputs(x1, x2, mode, act):
    """K2's inputs; for K(x, x) x2, v2s and dv2s are x1, v1s and dv1s."""
    import torch
    from snngp_torch.ops import gram as G

    w, b, last = (torch.tensor(v, device="cuda") for v in (W_STD, B_STD, LAST_W_STD))
    x1 = x1.contiguous()
    v1s, dv1s = (t.contiguous() for t in G._stack_with_tangents(mode, x1, DEPTH, act, w, b))
    if x2 is None:
        x2, v2s, dv2s = x1, v1s, dv1s
    else:
        v2s, dv2s = (t.contiguous()
                     for t in G._stack_with_tangents(mode, x2, DEPTH, act, w, b))
    scales = torch.stack([w * w, b * b, last * last,
                          torch.tensor(1.0 / x1.shape[1], device="cuda"), w, b, last])
    return [x1, x2.contiguous(), v1s, v2s, dv1s, dv2s, scales]


def _k2_check(args, g, kw, label):
    """K2 against its plain version on one cotangent (a symmetric launch
    where x2 is x1); returns the row."""
    import torch
    from snngp_torch.ops import gram as G

    same = args[1] is args[0]
    s_kernel = G.gram_grads_cuda(*args, g, **kw, same=same)
    repeat = torch.equal(s_kernel, G.gram_grads_cuda(*args, g, **kw, same=same))
    s_plain = G.gram_grads_plain(*args, g, **kw)
    _, dkw, dkb, dkl = G.gram_tangents_plain(*args, **kw)
    g64 = g.double().abs()
    scale = torch.stack([torch.sum(g64 * t.double().abs()) for t in (dkw, dkb, dkl)])
    del dkw, dkb, dkl, g64
    abs_err = (s_kernel - s_plain).abs()
    rel = (abs_err / scale).max().item()
    finite = bool(torch.isfinite(s_kernel).all())
    ms = _time_ms(lambda: G.gram_grads_cuda(*args, g, **kw, same=same))
    plain_ms = _time_ms(lambda: G.gram_grads_plain(*args, g, **kw), reps=2)
    print(f"[K2] {label:34s} rel_err {rel:.3e} abs_err {abs_err.max().item():.3e}  "
          f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  repeat bitwise {repeat}  sums "
          + " ".join(f"{v:.6e}" for v in s_kernel.tolist()))
    if not finite or not rel <= K2_REL_TOL or not repeat:
        raise AssertionError(f"K2 {label}: rel_err {rel:.3e} (tol {K2_REL_TOL}), "
                             f"finite={finite}, repeat={repeat}")
    n1, n2 = g.shape
    nbytes = _read_bytes(args) + g.numel() * 4 + 3 * G.gram_blocks(n1, n2, same) * 8
    bound, by = bound_ms(nbytes, *k2_ops(n1, n2, args[0].shape[1], kw["depth"],
                                          kw["act"], kw["mode"], same))
    return dict(ms=ms, plain_ms=plain_ms, rel_err=rel, abs_err=abs_err.max().item(),
                bound_ms=bound, bound_by=by)


def phase4_k2_vs_plain(x_train, ml2_cotangent):
    """K2 against its plain version at phase 1's shapes, on a random
    cotangent and, at 10,000 x 16, also on the training inputs with the
    cotangent of the ML-II loss."""
    import torch

    rng = np.random.RandomState(4)
    rows = {}
    for shape_name, (n1, n2, d) in SHAPES.items():
        x1 = torch.as_tensor(rng.randn(n1, d).astype(np.float32), device="cuda")
        x2 = None if n2 is None else torch.as_tensor(
            rng.randn(n2, d).astype(np.float32), device="cuda")
        g = torch.as_tensor(rng.randn(n1, n2 or n1).astype(np.float32), device="cuda")
        cases = {"random": (x1, x2, g)}
        if shape_name == HEAD_SHAPE:
            cases["ml2"] = (x_train, None, ml2_cotangent)
        for mode in ("mlp", "resnet"):
            for act in ("relu", "erf"):
                for case, (a1, a2, cot) in cases.items():
                    rows[f"{mode}/{act}/{shape_name}/{case}"] = _k2_check(
                        _k2_inputs(a1, a2, mode, act), cot,
                        dict(depth=DEPTH, act=act, mode=mode),
                        f"{mode} {act} {shape_name} {case}")
        del x1, x2, g, cases
    _k2_repeat_and_depth(x_train, ml2_cotangent)
    torch.cuda.empty_cache()
    return rows


def _k2_repeat_and_depth(x_train, cot):
    """K2's sums repeat bitwise (a fixed-order reduction, no atomics) and
    give the same bits for g and g^T on K(x, x), and K2 holds its plain
    version at depth K2_DEEP (the factors of 8 layers staged a pass)."""
    import torch
    from snngp_torch.ops import gram as G

    args = _k2_inputs(x_train, None, "mlp", "relu")
    kw = dict(depth=DEPTH, act="relu", mode="mlp", same=True)
    first, second = (G.gram_grads_cuda(*args, cot, **kw) for _ in range(2))
    transposed = G.gram_grads_cuda(*args, cot.T.contiguous(), **kw)
    if not (torch.equal(first, second) and torch.equal(first, transposed)):
        raise AssertionError(f"K2 sums differ between two runs or for g^T: {first} {second} "
                             f"{transposed}")
    depth = K2_DEEP
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.randn(300, 8).astype(np.float32), device="cuda")
    w, b, last = (torch.tensor(v, device="cuda") for v in (1.0, 0.1, 1.0))
    v, dv = G._stack_with_tangents("mlp", x, depth, "relu", w, b)
    scales = torch.stack([w * w, b * b, last * last, torch.tensor(1.0 / 8, device="cuda"),
                          w, b, last])
    g = torch.as_tensor(rng.randn(300, 300).astype(np.float32), device="cuda")
    kw = dict(depth=depth, act="relu", mode="mlp")
    got = G.gram_grads_cuda(x, x, v, v, dv, dv, scales, g, **kw, same=True)
    want = G.gram_grads_plain(x, x, v, v, dv, dv, scales, g, **kw)
    rel = ((got - want).abs() / want.abs()).max().item()
    print(f"[K2] sums repeat bitwise and equal for g^T: True; depth {depth} vs plain "
          f"rel err {rel:.3e}")
    if not rel <= K2_REL_TOL:
        raise AssertionError(f"K2 at depth {depth}: rel err {rel:.3e}")


# -- K3 and K4 ------------------------------------------------------------------

def k3_ops(n1, n2, hw, c, depth, act, same):
    """fp32 operations of K3 on these shapes (see _dual_act_ops): per pixel
    the input moment (C FMAs and a scale), per pixel and layer the stencil's
    4 adds and divide, the Dense FMA and the dual activation, then the
    readout's add; per pair the final scale."""
    a = _dual_act_ops(act, False)
    return _pairs(n1, n2, same) * (hw * (2 * c + 1) + depth * hw * (7 + a) + hw + 1)


def k4_ops(n1, n2, hw, c, depth, act, same):
    """(fp32, fp64) operations of K4 on these shapes: per pixel and layer
    three stencils (12 adds, 3 divides), u / du_w / du_b (7), the partials
    and the two tangent updates (10); three readout adds per pixel; the
    contraction's three fp64 FMAs per pair."""
    p = _dual_act_ops(act, True)
    pairs = _pairs(n1, n2, same)
    return pairs * (hw * (2 * c + 1) + depth * hw * (32 + p) + 3 * hw + 3), pairs * 6


def _conv_inputs(rng, n1, n2, h, w, c, same):
    import torch
    x1 = torch.as_tensor(rng.randn(n1, h, w, c).astype(np.float32), device="cuda")
    x2 = x1 if same else torch.as_tensor(rng.randn(n2, h, w, c).astype(np.float32),
                                         device="cuda")
    return x1, x2


def _conv_stacks(x1, x2, depth, act, tangents):
    """The kernels' variance maps (and, for K4, their tangents) and scales."""
    import torch
    from snngp_torch.ops import conv_gram as CG

    w, b, last = (torch.tensor(v, device="cuda") for v in (W_STD, B_STD, LAST_W_STD))
    inv_c = torch.tensor(1.0 / x1.shape[-1], device="cuda")
    if not tangents:
        v1s = CG._flat_stack(x1, depth, act, w, b)
        v2s = v1s if x2 is x1 else CG._flat_stack(x2, depth, act, w, b)
        return [t.contiguous() for t in (x1, x2, v1s, v2s,
                                         torch.stack([w * w, b * b, last * last, inv_c]))]
    v1s, dv1s = CG._stack_with_tangents(x1, depth, act, w, b)
    v2s, dv2s = ((v1s, dv1s) if x2 is x1
                 else CG._stack_with_tangents(x2, depth, act, w, b))
    scales = torch.stack([w * w, b * b, last * last, inv_c, w, b, last])
    return [t.contiguous() for t in (x1, x2, v1s, v2s, dv1s, dv2s, scales)]


def _conv_cases():
    """(label, n1, n2, h, w, c, same, depth): the three Gram blocks of one
    SVSP step at the CIFAR shape (K(x_b, Z), K(Z, Z), K(x_b, x_b)), both
    acts on distinct and on identical operands, MNIST's 28 x 28 x 1, the
    synthetic set's 8 x 8 x 1, an image wider than 32 (streamed
    transposed), and depths 1 and 10."""
    return [("100x200 32x32x3", 100, 200, 32, 32, 3, False, SVSP_DEPTH),
            ("200x200 32x32x3 sym", 200, 200, 32, 32, 3, True, SVSP_DEPTH),
            ("100x100 32x32x3 sym", 100, 100, 32, 32, 3, True, SVSP_DEPTH),
            ("100x100 32x32x3", 100, 100, 32, 32, 3, False, SVSP_DEPTH),
            ("64x96 28x28x1", 64, 96, 28, 28, 1, False, SVSP_DEPTH),
            ("300x300 8x8x1 sym", 300, 300, 8, 8, 1, True, SVSP_DEPTH),
            ("64x96 8x100x1", 64, 96, 8, 100, 1, False, SVSP_DEPTH),
            ("40x50 32x32x3 depth 1", 40, 50, 32, 32, 3, False, 1),
            ("40x50 32x32x3 depth 10", 40, 50, 32, 32, 3, False, 10)]


def phase7_k3_vs_plain():
    """K3 against its plain version on the same inputs; gate: max|K_kernel -
    K_plain| / max|K_plain| <= 1e-5; a second launch gives the same bits;
    identical operands (a symmetric launch) give a bitwise symmetric K."""
    import torch
    from snngp_torch.ops import conv_gram as CG

    rng = np.random.RandomState(7)
    rows, worst_abs = {}, 0.0
    for label, n1, n2, h, w, c, same, depth in _conv_cases():
        x1, x2 = _conv_inputs(rng, n1, n2, h, w, c, same)
        for act in ("relu", "erf"):
            args = _conv_stacks(x1, x2, depth, act, tangents=False)
            kw = dict(depth=depth, act=act)
            k_kernel = CG.conv_gram_cuda(*args, **kw, same=same)
            repeat = torch.equal(k_kernel, CG.conv_gram_cuda(*args, **kw, same=same))
            k_plain = CG.conv_gram_plain(*args, **kw)
            _sync()
            abs_err = (k_kernel - k_plain).abs().max().item()
            rel_err = abs_err / k_plain.abs().max().item()
            finite = bool(torch.isfinite(k_kernel).all())
            sym = (k_kernel - k_kernel.T).abs().max().item() if same else float("nan")
            ms = _time_ms(lambda: CG.conv_gram_cuda(*args, **kw, same=same))
            plain_ms = _time_ms(lambda: CG.conv_gram_plain(*args, **kw), reps=2)
            nbytes = _read_bytes(args) + n1 * n2 * 4
            bound, by = bound_ms(nbytes, k3_ops(n1, n2, h * w, c, depth, act, same))
            print(f"[K3] {act:4s} {label:24s} rel_err {rel_err:.3e} abs_err {abs_err:.3e}  "
                  f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bound:.3f} ms ({by}, "
                  f"{100 * bound / ms:.2f}%)  repeat {repeat}  max|K-K^T| {sym:.3e}")
            if not finite or not rel_err <= KERNEL_REL_TOL or not repeat:
                raise AssertionError(f"K3 {act} at {label}: rel_err {rel_err:.3e} "
                                     f"(tol {KERNEL_REL_TOL}), finite={finite}, "
                                     f"repeat={repeat}")
            if same and sym != 0.0:
                raise AssertionError(f"K3 {act} at {label}: K(x, x) not symmetric ({sym})")
            worst_abs = max(worst_abs, abs_err)
            rows[f"{act}/{label}"] = dict(ms=ms, plain_ms=plain_ms, rel_err=rel_err,
                                          abs_err=abs_err, bound_ms=bound, bound_by=by)
            del k_kernel, k_plain, args
    torch.cuda.empty_cache()
    return rows, worst_abs


def phase8_k4_vs_plain():
    """K4 against its plain version at phase 7's cases on a random
    cotangent (not symmetric; identical operands take the symmetric launch,
    ``same=True``); gate: for each of the three sums, |s_kernel - s_plain| /
    sum |g dK| <= 1e-5; two launches give the same bits. Then one
    scalar-only gradient through get_cnn_kernel(trainable_inputs=False)
    against float64 autograd through the plain layer tier."""
    import torch
    from snngp_torch.ops import conv_gram as CG

    with torch.inference_mode():
        rows = _k4_cases()
    torch.cuda.empty_cache()
    _k4_scalar_gradient()
    return rows


def _k4_cases():
    import torch
    from snngp_torch.ops import conv_gram as CG

    rng = np.random.RandomState(8)
    rows = {}
    for label, n1, n2, h, w, c, same, depth in _conv_cases():
        x1, x2 = _conv_inputs(rng, n1, n2, h, w, c, same)
        g = torch.as_tensor(rng.randn(n1, n2).astype(np.float32), device="cuda")
        for act in ("relu", "erf"):
            args = _conv_stacks(x1, x2, depth, act, tangents=True)
            kw = dict(depth=depth, act=act)
            s_kernel = CG.conv_gram_grads_cuda(*args, g, **kw, same=same)
            again = CG.conv_gram_grads_cuda(*args, g, **kw, same=same)
            s_plain = CG.conv_gram_grads_plain(*args, g, **kw)
            _, dkw, dkb, dkl = CG.conv_gram_tangents_plain(*args, **kw)
            g64 = g.double().abs()
            scale = torch.stack([torch.sum(g64 * t.double().abs()) for t in (dkw, dkb, dkl)])
            del dkw, dkb, dkl, g64
            abs_err = (s_kernel - s_plain).abs()
            rel = (abs_err / scale).max().item()
            finite = bool(torch.isfinite(s_kernel).all())
            repeat = torch.equal(s_kernel, again)
            ms = _time_ms(lambda: CG.conv_gram_grads_cuda(*args, g, **kw, same=same))
            plain_ms = _time_ms(lambda: CG.conv_gram_grads_plain(*args, g, **kw), reps=2)
            # g whole (a symmetric launch reads g[i, j] and g[j, i]), and the
            # kernel's float64 partial triples.
            nbytes = (_read_bytes(args) + g.numel() * 4
                      + 3 * 8 * CG.grads_blocks(n1, n2, h, w, depth, same))
            bound, by = bound_ms(nbytes, *k4_ops(n1, n2, h * w, c, depth, act, same))
            print(f"[K4] {act:4s} {label:24s} rel_err {rel:.3e} abs_err "
                  f"{abs_err.max().item():.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
                  f"bound {bound:.3f} ms ({by})  repeat {repeat}  sums "
                  + " ".join(f"{v:.6e}" for v in s_kernel.tolist()))
            if not finite or not rel <= K2_REL_TOL or not repeat:
                raise AssertionError(f"K4 {act} at {label}: rel_err {rel:.3e} (tol "
                                     f"{K2_REL_TOL}), finite={finite}, repeat={repeat}")
            rows[f"{act}/{label}"] = dict(ms=ms, plain_ms=plain_ms, rel_err=rel,
                                          abs_err=abs_err.max().item(), bound_ms=bound,
                                          bound_by=by)
            del args
    return rows


def _k4_scalar_gradient():
    """d sum(g K) / d(w, b, last) through get_cnn_kernel(trainable_inputs=
    False) (K3 forward, K4 backward) against float64 and fp32 autograd
    through the plain layer tier; gate: within 2x the fp32 tier's error."""
    import torch
    from snngp_torch.nn import arch, layers
    from snngp_torch.ops import conv_gram as CG

    rng = np.random.RandomState(9)
    x1 = rng.randn(60, 32, 32, 3).astype(np.float32)
    x2 = rng.randn(80, 32, 32, 3).astype(np.float32)
    g = rng.randn(60, 80)
    grads = {}
    for name, dtype in (("kernel", torch.float32), ("plain fp32", torch.float32),
                        ("plain fp64", torch.float64)):
        like = dict(device="cuda", dtype=dtype)
        w, b, last = (torch.tensor(v, requires_grad=True, **like)
                      for v in (W_STD, B_STD, LAST_W_STD))
        if name == "kernel":
            kfn = arch.get_cnn_kernel(SVSP_DEPTH, 1, "relu", w, b, last,
                                      trainable_inputs=False)
        else:
            kfn = layers.kernel_fn_of(arch.get_cnn_layer(SVSP_DEPTH, 1, "relu", w, b, last))
        before = CG.LAUNCHES["conv_gram_grads"]
        k = kfn(torch.as_tensor(x1, **like), torch.as_tensor(x2, **like))
        grads[name] = torch.stack(torch.autograd.grad(
            torch.sum(torch.as_tensor(g, **like) * k), (w, b, last))).double()
        if name == "kernel" and CG.LAUNCHES["conv_gram_grads"] != before + 1:
            raise AssertionError("the scalar-only CNN gradient did not launch K4")
    g64 = grads["plain fp64"]
    errs = {n: ((grads[n] - g64).norm() / g64.norm()).item() for n in ("kernel", "plain fp32")}
    print(f"[K4] get_cnn_kernel(trainable_inputs=False) 60x80 32x32x3: d/d(w, b, last) "
          + " ".join(f"{v:.8e}" for v in grads["kernel"].tolist())
          + f"; rel err vs fp64: kernel {errs['kernel']:.3e}, plain fp32 {errs['plain fp32']:.3e}")
    if not errs["kernel"] <= 2.0 * max(errs["plain fp32"], 1e-6):
        raise AssertionError(f"K4 scalar gradient error {errs['kernel']:.3e} above 2x the "
                             f"plain fp32 error {errs['plain fp32']:.3e}")


# -- serving --------------------------------------------------------------------

def _serving_data():
    rng = np.random.RandomState(1)
    x = rng.randn(SERVE_N, SERVE_D).astype(np.float32)
    u = rng.randn(SERVE_D) / math.sqrt(SERVE_D)
    x_req = rng.randn(REQUESTS * REQUEST_SIZE, SERVE_D).astype(np.float32)
    y = np.sin(2.0 * x @ u) + 0.5 * np.cos(x[:, 0]) + 0.1 * rng.randn(SERVE_N)
    y_mean, y_std = y.mean(), y.std()
    return x, ((y - y_mean) / y_std).astype(np.float32), x_req, y_mean, y_std


def _model(x, y, y_mean, y_std, *, fused, dtype, eps=SERVE_EPS):
    """The depth-4 ReLU MLP NNGP with a Student-t likelihood, built as the
    CLI builds it (scalar-tangent backward: ML-II trains only the scales)
    or on the plain layer tier."""
    from snngp_torch.models import SPR, NNGPKernel, StudentTLikelihood
    from snngp_torch.nn import arch, layers

    if fused:
        def get_kernel_fn(w, b, last):
            return arch.get_mlp_kernel(DEPTH, act="relu", w_std=w, b_std=b, last_w_std=last,
                                       trainable_inputs=False)
    else:  # the plain layer tier, an independent reference
        def get_kernel_fn(w, b, last):
            return layers.kernel_fn_of(arch.get_mlp_layer(DEPTH, 1, "relu", w, b, last))
    model = SPR(NNGPKernel(get_kernel_fn, W_STD, B_STD, LAST_W_STD),
                StudentTLikelihood(2.0, 2.0), x, y, y_mean, y_std, eps=eps)
    return model.to(device="cuda", dtype=dtype)


def _raise_with_spectrum(gram, what):
    """A failed factorization: report the Gram's spectrum, then fail."""
    import torch
    ev = torch.linalg.eigvalsh(gram.detach().double())
    raise AssertionError(
        f"{what}: fp{torch.finfo(gram.dtype).bits} factorization failed; "
        f"Gram eigenvalues min {ev[0].item():.3e} max {ev[-1].item():.3e}")


def _serve(model, x_req, *, timed):
    """fit_spr, then REQUESTS predictions; returns (mean, var, timings)."""
    import torch
    from snngp_torch.models import fit_spr

    timings = {}
    _sync()
    t0 = time.perf_counter()
    gram = model._gram(model.kernel.get_kernel_fn())
    _sync()
    t1 = time.perf_counter()
    fitted = fit_spr(model, gram=gram, t_jitter=SERVE_T_JITTER)
    _sync()
    t2 = time.perf_counter()
    timings["gram_s"], timings["factor_s"] = t1 - t0, t2 - t1
    bad = {k: v.item() for k, v in fitted.state.items()
           if v.numel() == 1 and not math.isfinite(v.item())}
    if bad or not bool(torch.isfinite(fitted.state["chol"]).all()):
        _raise_with_spectrum(gram, f"serving ({bad})")
    del gram
    xs = torch.as_tensor(x_req, device="cuda", dtype=model.x_data.dtype)
    means, vars_, lat = [], [], []
    for i in range(REQUESTS):
        xr = xs[i * REQUEST_SIZE:(i + 1) * REQUEST_SIZE]
        t = time.perf_counter()
        mean, var = fitted.predict(xr, batch=PREDICT_BATCH)
        _sync()
        lat.append(time.perf_counter() - t)
        means.append(mean)
        vars_.append(var)
    timings["request_s"] = lat
    if timed:
        print(f"[serve] fit: gram {timings['gram_s']:.4f} s  cholesky+solves "
              f"{timings['factor_s']:.4f} s  d={fitted.state['d'].item():.4f}")
        print("[serve] request latency (1,000 points each): "
              + "  ".join(f"{s * 1e3:.2f} ms" for s in lat))
    return torch.cat(means), torch.cat(vars_), timings


def _warm_up(data):
    """One untimed serve on the plain fp32 tier at the serving shapes: the
    first use of each cuSOLVER / cuBLAS kernel at these sizes loads its
    module (~0.1 s in the fit, ~0.6 s in the first request on the H100), and
    the caching allocator reserves the N x N buffers. The timed runs below
    then measure steady-state work, as a warmed-up server would see."""
    import torch

    x, y, x_req, y_mean, y_std = data
    _serve(_model(x, y, y_mean, y_std, fused=False, dtype=torch.float32),
           x_req, timed=False)


def phase2_serving(data):
    import torch
    from snngp_torch.ops import gram as G

    x, y, x_req, y_mean, y_std = data
    print(f"[serve] N={SERVE_N} D={SERVE_D} depth {DEPTH} relu MLP, Student-t a=b=2, "
          f"eps={SERVE_EPS} (relative), t_jitter={SERVE_T_JITTER}")
    before = G.LAUNCHES["gram"]
    model = _model(x, y, y_mean, y_std, fused=True, dtype=torch.float32)
    mean_k, var_k, timings = _serve(model, x_req, timed=True)
    launched = G.LAUNCHES["gram"] - before
    expected = 1 + REQUESTS * 2  # train Gram; cross + test Gram per request
    print(f"[serve] kernel launches {launched} (expected {expected})")
    del model

    ref = {}
    for name, dtype in (("plain fp32", torch.float32), ("plain fp64", torch.float64)):
        m = _model(x, y, y_mean, y_std, fused=False, dtype=dtype)
        mean, var, t = _serve(m, x_req, timed=False)
        print(f"[serve] {name}: gram {t['gram_s']:.4f} s  cholesky+solves {t['factor_s']:.4f} s")
        ref[name] = (mean.double(), var.double())
        del m

    mean64, var64 = ref["plain fp64"]

    def err(a, ref_):
        return ((a.double() - ref_).abs().max() / ref_.abs().max()).item()

    errs = {"kernel": (err(mean_k, mean64), err(var_k, var64)),
            "plain fp32": (err(ref["plain fp32"][0], mean64), err(ref["plain fp32"][1], var64))}
    for name, (em, ev) in errs.items():
        print(f"[serve] {name:10s} vs fp64: mean rel err {em:.3e}  var rel err {ev:.3e}")

    finite = all(bool(torch.isfinite(t).all()) for t in (mean_k, var_k))
    positive = bool((var_k > 0).all())
    print(f"[serve] outputs finite {finite}, variances positive {positive}, "
          f"shapes {tuple(mean_k.shape)} {tuple(var_k.shape)}")
    if not (finite and positive):
        raise AssertionError("serving outputs not finite / variances not positive")
    if mean_k.shape != (REQUESTS * REQUEST_SIZE,) or var_k.shape != mean_k.shape:
        raise AssertionError(f"unexpected output shapes {mean_k.shape}, {var_k.shape}")
    # "About 2x": the floor keeps a plain error below fp32 resolution from
    # making the bar unreachable.
    for i, what in enumerate(("mean", "var")):
        bar = 2.0 * max(errs["plain fp32"][i], 1e-6)
        if not errs["kernel"][i] <= bar:
            raise AssertionError(f"kernel-path {what} error {errs['kernel'][i]:.3e} "
                                 f"above 2x the plain fp32 error ({bar:.3e})")
    if launched != expected:
        raise AssertionError(f"kernel launched {launched} times, expected {expected}")
    return timings, errs, (mean64, var64)


def _run_cli(argv):
    """``python -m snngp_torch <argv>``, in this process (so its kernel
    launches are counted)."""
    saved = sys.argv
    sys.argv = ["snngp_torch", *argv]
    try:
        runpy.run_module("snngp_torch", run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved


def _nll(log_path):
    text = Path(log_path).read_text()
    if "Traceback" in text or "NLL:" not in text:
        raise AssertionError(f"{log_path}: no NLL\n{text}")
    return float(text.split("NLL:")[-1].split()[0])


def phase3_cli():
    from snngp_torch.models.bijectors import positive
    from snngp_torch.ops import gram as G
    from snngp_torch.utils import save_params

    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    ckpt = work / "syn-t-tp"
    ckpt.mkdir(parents=True)
    import torch
    inv = positive().inverse
    raw = lambda v: inv(torch.tensor(v, dtype=torch.float32)).numpy()  # noqa: E731
    save_params(str(ckpt / "000.npz"), {
        "eps": raw(1e-2),
        "kernel": {"w_std": raw(W_STD), "b_std": raw(B_STD), "last_w_std": raw(LAST_W_STD)},
        "likelihood": {"a": raw(CLI_A), "b": raw(CLI_B)},
    })
    np.save(ckpt / "meta.npy", dict(args=dict(
        method="tp", network="mlp", data_name="syn-t", num_hiddens=DEPTH,
        activation="relu", w_std=W_STD, b_std=B_STD, last_w_std=LAST_W_STD,
        alpha=CLI_A, beta=CLI_B, epsilon=1e-2)))
    common = ["-cd", str(ckpt), "-dr", str(work / "data"), "-q"]
    fitted = ckpt / "fitted.npz"

    before = G.LAUNCHES["gram"]
    _run_cli(["--device", "cuda", "reg", "ts", *common])
    nll_ts = _nll(ckpt / "test" / "test.log")
    _run_cli(["--device", "cuda", "reg", "pr", *common, "-fs", str(fitted)])
    nll_pr = _nll(ckpt / "predict" / "predict.log")
    preds = np.load(ckpt / "predictions.npz")
    if not fitted.exists():
        raise AssertionError("reg pr -fs wrote no fitted state")
    _run_cli(["--device", "cuda", "reg", "pr", *common, "-fs", str(fitted)])
    pr2_log = (ckpt / "predict" / "predict.log").read_text()
    nll_pr2 = _nll(ckpt / "predict" / "predict.log")
    launched = G.LAUNCHES["gram"] - before
    _run_cli(["--device", "cpu", "reg", "ts", *common])
    nll_cpu = _nll(ckpt / "test" / "test.log")

    print(f"[cli] syn-t tp: reg ts NLL {nll_ts:.5f} (cuda) {nll_cpu:.5f} (cpu); "
          f"reg pr NLL {nll_pr:.5f} (fit) {nll_pr2:.5f} (cached)")
    print(f"[cli] predictions {preds['mean'].shape}, kernel launches {launched}")
    if "loaded fitted state" not in pr2_log:
        raise AssertionError("second reg pr did not load the fitted state")
    if not (np.all(np.isfinite(preds["mean"])) and np.all(preds["var"] > 0)):
        raise AssertionError("predictions.npz not finite / var not positive")
    if not all(math.isfinite(v) for v in (nll_ts, nll_pr, nll_pr2, nll_cpu)):
        raise AssertionError("non-finite NLL")
    np.testing.assert_allclose(nll_ts, nll_cpu, rtol=CLI_RTOL)
    np.testing.assert_allclose(nll_pr, nll_ts, rtol=CLI_RTOL)
    np.testing.assert_allclose(nll_pr2, nll_pr, rtol=1e-6)
    if launched <= 0:
        raise AssertionError("the CLI never launched the Gram kernel")


# -- training -------------------------------------------------------------------

def _loss_and_grads(model):
    """ML-II loss and its six gradients, in sorted-name order, as float64."""
    import torch

    model.zero_grad(set_to_none=True)
    gram = model._gram(model.kernel.get_kernel_fn())
    loss = model.loss(gram)
    if not math.isfinite(loss.item()):
        _raise_with_spectrum(gram, "ML-II loss")
    loss.backward()
    names = sorted(n for n, _ in model.named_parameters())
    params = dict(model.named_parameters())
    return loss.item(), names, torch.stack([params[n].grad.double() for n in names])


def ml2_cotangent(data):
    """dLoss/dK of the ML-II loss at the initial parameters, on the training
    inputs (phase 4's realistic cotangent); returns (x_train, g)."""
    import torch

    x, y, _, y_mean, y_std = data
    model = _model(x, y, y_mean, y_std, fused=True, dtype=torch.float32, eps=TRAIN_EPS)
    gram = model._gram(model.kernel.get_kernel_fn())
    gram.retain_grad()
    model.loss(gram).backward()
    return model.x_data, gram.grad.detach()


def phase5_training(data):
    import torch
    from snngp_torch.ops import gram as G
    from snngp_torch.sklearn import SNNGPRegressor
    from snngp_torch.utils import Profiler

    x, y, x_req, y_mean, y_std = data
    print(f"[train] N={SERVE_N} D={SERVE_D} depth {DEPTH} relu MLP, Student-t a=b=2, "
          f"eps={TRAIN_EPS} (absolute)")
    grads, errs = {}, {}
    for name, fused, dtype in (("kernel", True, torch.float32),
                               ("plain fp32", False, torch.float32),
                               ("plain fp64", False, torch.float64)):
        torch.cuda.reset_peak_memory_stats()
        before = dict(G.LAUNCHES)
        t0 = time.perf_counter()
        model = _model(x, y, y_mean, y_std, fused=fused, dtype=dtype, eps=TRAIN_EPS)
        loss, names, grads[name] = _loss_and_grads(model)
        _sync()
        wall = time.perf_counter() - t0
        launched = {k: G.LAUNCHES[k] - before[k] for k in before}
        print(f"[train] {name:10s} loss {loss:.8f}  grads "
              + " ".join(f"{n}={v:.6e}" for n, v in zip(names, grads[name].tolist()))
              + f"  {wall:.3f} s  peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
              f"  launches {launched}")
        del model
        torch.cuda.empty_cache()
    g64 = grads["plain fp64"]
    for name in ("kernel", "plain fp32"):
        errs[name] = ((grads[name] - g64).norm() / g64.norm()).item()
        per = ((grads[name] - g64).abs() / g64.abs()).tolist()
        print(f"[train] {name:10s} vs fp64: gradient rel err {errs[name]:.3e}  per parameter "
              + " ".join(f"{v:.2e}" for v in per))
    bar = 2.0 * max(errs["plain fp32"], 1e-6)
    if not errs["kernel"] <= bar:
        raise AssertionError(f"kernel-path gradient error {errs['kernel']:.3e} above 2x "
                             f"the plain fp32 error ({bar:.3e})")
    gradients = dict(g64=g64, kernel_err=errs["kernel"])

    X = x * 1.0
    y_raw = y * y_std + y_mean
    prof = Profiler()
    before = dict(G.LAUNCHES)
    _sync()
    t0 = time.perf_counter()
    reg = SNNGPRegressor(method="tp", num_hiddens=DEPTH, activation="relu", w_std=W_STD,
                         b_std=B_STD, last_w_std=LAST_W_STD, eps=TRAIN_EPS,
                         max_steps=TRAIN_STEPS, device="cuda").fit(X, y_raw, profiler=prof)
    _sync()
    fit_s = time.perf_counter() - t0
    launched = {k: G.LAUNCHES[k] - before[k] for k in before}
    losses = reg.losses_
    print(f"[train] SNNGPRegressor.fit: {TRAIN_STEPS} steps + fit_spr in {fit_s:.4f} s; "
          f"losses " + " ".join(f"{v:.6f}" for v in losses))
    print(f"[train] fit launches {launched} (expected gram {TRAIN_STEPS + 1}: one per "
          f"step and fit_spr's; gram_grads {TRAIN_STEPS}: one per step)")
    steps = {k: 1e3 * prof.totals[k] / prof.counts[k] for k in prof.totals}
    print("[train] ML-II step (synchronized host clock, mean of "
          f"{TRAIN_STEPS}): " + "  ".join(f"{k} {v:.3f} ms" for k, v in steps.items())
          + f"  total {sum(steps.values()):.3f} ms")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"ML-II losses not finite and decreasing: {losses}")
    if launched != {"gram": TRAIN_STEPS + 1, "gram_grads": TRAIN_STEPS}:
        raise AssertionError(f"fit launched {launched}; expected one K1 and one K2 "
                             "per step, plus fit_spr's K1")

    t0 = time.perf_counter()
    mean, std = reg.predict(x_req[:REQUEST_SIZE], return_std=True)
    predict_s = time.perf_counter() - t0
    print(f"[train] predict {REQUEST_SIZE} points in {predict_s * 1e3:.2f} ms: "
          f"shapes {mean.shape} {std.shape}, finite "
          f"{bool(np.all(np.isfinite(mean)) and np.all(np.isfinite(std)))}")
    if mean.shape != (REQUEST_SIZE,) or std.shape != mean.shape:
        raise AssertionError(f"unexpected predict shapes {mean.shape}, {std.shape}")
    if not (np.all(np.isfinite(mean)) and np.all(std > 0)):
        raise AssertionError("predictions not finite / std not positive")
    _warm_steps(reg.model_)
    _profile_step(reg.model_)
    return dict(errs=errs, steps_ms=steps, fit_s=fit_s, losses=losses.tolist(),
                gradients=gradients)


def _warm_steps(model, n=5):
    """n more ML-II steps (lr 0: the parameters stay as fitted), each phase
    of each step on its own: the spread that the fit's mean hides."""
    from snngp_torch.utils import Adam, Profiler, train_step

    opt = Adam(model)
    for i in range(n):
        prof = Profiler()
        train_step(model, opt, 0.0, prof)
        ms = {k: 1e3 * v for k, v in prof.totals.items()}
        print(f"[train] warm step {i}: " + "  ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f"  total {sum(ms.values()):.3f} ms")


def _profile_step(model, top=12):
    """One warm ML-II step under torch.profiler (see _profile)."""
    from snngp_torch.utils import Adam, train_step

    opt = Adam(model)
    # lr 0: the parameters stay as fitted.
    _profile(lambda: train_step(model, opt, 0.0), "one ML-II step", top)


def _profile(step, label, top=12):
    """One warm call of ``step`` under torch.profiler: device time by kernel
    (self time), and the step's device time against its wall time (the
    profiler adds host overhead, so the idle share it implies is an upper
    bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    _sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        _sync()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Kernels only: an operator's own event carries the device time of the
    # kernels it launched, which would count them twice.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    total_ms = sum(device_us(e) for e in events) / 1e3
    print(f"[profile] {label}: kernels {total_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"(profiled); top {top} kernels by device time:")
    for e in sorted(events, key=device_us, reverse=True)[:top]:
        print(f"[profile]   {device_us(e) / 1e3:9.3f} ms  {100 * device_us(e) / 1e3 / total_ms:5.1f}%"
              f"  x{e.count:<4d} {e.key[:90]}")


def _best_nll(log_path):
    """NLL of the final best-step line of a ``reg tr`` log."""
    text = Path(log_path).read_text()
    if "Traceback" in text:
        raise AssertionError(f"{log_path}:\n{text}")
    best = [line for line in text.splitlines() if line.startswith("[") and "TEST:" in line]
    return float(best[-1].split("NLL:")[1].split()[0])


def phase6_train_cli():
    work = REPO / "build" / "chip_smoke" / "train"
    shutil.rmtree(work, ignore_errors=True)
    common = [*CLI_TRAIN, "-cr", str(work), "-dr", str(work / "data")]
    t0 = time.perf_counter()
    _run_cli(["--device", "cuda", "reg", "tr", *common, "-t", "20", "-cn", "cuda"])
    t_cuda = time.perf_counter() - t0
    nll_cuda = _best_nll(work / "cuda" / "train.log")
    _run_cli(["--device", "cuda", "reg", "ts", "-cd", str(work / "cuda"),
              "-dr", str(work / "data"), "-q"])
    nll_ts = _nll(work / "cuda" / "test" / "test.log")
    _run_cli(["--device", "cuda", "reg", "tr", *common, "-t", "30", "-cn", "cuda", "-rs"])
    resumed = (work / "cuda" / "train.log").read_text()
    nll_resumed = _best_nll(work / "cuda" / "train.log")
    t0 = time.perf_counter()
    _run_cli(["--device", "cpu", "reg", "tr", *common, "-t", "20", "-cn", "cpu"])
    t_cpu = time.perf_counter() - t0
    nll_cpu = _best_nll(work / "cpu" / "train.log")
    print(f"[cli] syn-normal tp reg tr -t 20: best NLL {nll_cuda:.5f} (cuda, {t_cuda:.2f} s) "
          f"{nll_cpu:.5f} (cpu, {t_cpu:.2f} s); reg ts {nll_ts:.5f}; "
          f"resumed to step 30: best NLL {nll_resumed:.5f}")
    if "at step 20" not in resumed or "[   30] nll:" not in resumed \
            or "[   10] nll:" in resumed:
        raise AssertionError(f"reg tr -rs did not resume from step 20:\n{resumed}")
    if not all(math.isfinite(v) for v in (nll_cuda, nll_cpu, nll_ts, nll_resumed)):
        raise AssertionError("non-finite NLL")
    np.testing.assert_allclose(nll_cuda, nll_cpu, rtol=CLI_RTOL)


# -- regression extras: extendable serving, reg fd, the MLP classifier ----------------

def _extension_data():
    """EXTEND_M new points of phase 2's generating function (the same
    direction u), their raw targets, and EXTEND_M more for the reload check."""
    rng = np.random.RandomState(1)
    rng.randn(SERVE_N, SERVE_D)
    u = rng.randn(SERVE_D) / math.sqrt(SERVE_D)
    rng = np.random.RandomState(18)
    x_new = rng.randn(2 * EXTEND_M, SERVE_D).astype(np.float32)
    y_new = (np.sin(2.0 * x_new @ u) + 0.5 * np.cos(x_new[:, 0])
             + 0.1 * rng.randn(2 * EXTEND_M)).astype(np.float32)
    return x_new[:EXTEND_M], y_new[:EXTEND_M], x_new[EXTEND_M:], y_new[EXTEND_M:]


def _bordered_fit(x_all, y_all, y_mean, y_std, reg, n0, dtype):
    """A fresh fit of the bordered matrix that ``extend`` factors, on the
    plain tier at ``dtype``: K + reg I with the frozen regularizer, and the
    Student-t factor of (b/a) K + jitter, SERVE_T_JITTER on the first n0
    points and EXTEND_T_JITTER on the rest."""
    import torch
    from snngp_torch.models import FittedSPR
    from snngp_torch.ops.linalg import chol_quad_form, chol_solve, cholesky

    model = _model(x_all, y_all, y_mean, y_std, fused=False, dtype=dtype)
    k = model._gram(model.kernel.get_kernel_fn())
    n = k.shape[0]
    chol = cholesky(k + float(reg) * torch.eye(n, dtype=dtype, device="cuda"))
    a, b = model.likelihood._ab()
    jitter = torch.full((n,), EXTEND_T_JITTER, dtype=dtype, device="cuda")
    jitter[:n0] = SERVE_T_JITTER
    chol_t = cholesky((b / a) * k + torch.diag(jitter))
    y = model.y_data
    state = {"chol": chol, "alpha": chol_solve(chol, y[:, None]), "y_mean": model.y_mean,
             "y_std": model.y_std, "d": 2.0 * a + chol_quad_form(chol_t, y),
             "cond_df": 2.0 * a + n, "scale_ba": b / a}
    return FittedSPR(model, state)


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def phase18_extend(data):
    """fit_spr(extendable=True) at phase 2's size, extended by EXTEND_M
    points: its predictive on a 1,000-point request against a float64
    factorization of the same bordered matrix (gate: within 2x a fresh fp32
    fit's error), extend against refit times, and save / load / extend again
    bitwise equal to the in-memory result."""
    import torch
    from snngp_torch.models import FittedSPR, fit_spr

    x, y, x_req, y_mean, y_std = data
    x_new, y_new, x_more, y_more = _extension_data()
    model = _model(x, y, y_mean, y_std, fused=True, dtype=torch.float32)
    fitted, t_fit = _timed(lambda: fit_spr(model, extendable=True, t_jitter=SERVE_T_JITTER))
    xn, yn = (torch.as_tensor(a, device="cuda") for a in (x_new, y_new))
    _, t_first = _timed(lambda: fitted.extend(xn, yn))      # loads the solver modules
    ext, t_ext = _timed(lambda: fitted.extend(xn, yn))
    x_all = ext.model.x_data.cpu().numpy()
    y_all = ext.model.y_data.cpu().numpy()
    refit_model = _model(x_all, y_all, y_mean, y_std, fused=True, dtype=torch.float32)
    _, t_refit = _timed(lambda: fit_spr(refit_model, t_jitter=SERVE_T_JITTER))
    del refit_model
    print(f"[extend] N={SERVE_N} + {EXTEND_M}: fit (extendable) {t_fit * 1e3:.2f} ms; extend "
          f"{t_ext * 1e3:.2f} ms (first call {t_first * 1e3:.2f} ms) against a refit of "
          f"{SERVE_N + EXTEND_M} points {t_refit * 1e3:.2f} ms")

    req = torch.as_tensor(x_req[:REQUEST_SIZE], device="cuda")
    mean_e, var_e = ext.predict(req, batch=PREDICT_BATCH)
    reg = float(fitted.state["reg"])
    ref = {}
    for name, dtype in (("plain fp32", torch.float32), ("plain fp64", torch.float64)):
        fresh = _bordered_fit(x_all, y_all, y_mean, y_std, reg, SERVE_N, dtype)
        ref[name] = [t.double() for t in fresh.predict(req.to(dtype), batch=PREDICT_BATCH)]
        del fresh
        torch.cuda.empty_cache()
    mean64, var64 = ref["plain fp64"]

    def err(a, want):
        return ((a.double() - want).abs().max() / want.abs().max()).item()

    errs = {"extend": (err(mean_e, mean64), err(var_e, var64)),
            "plain fp32": (err(ref["plain fp32"][0], mean64), err(ref["plain fp32"][1], var64))}
    for name, (em, ev) in errs.items():
        print(f"[extend] {name:10s} vs fp64 bordered fit: mean rel err {em:.3e}  "
              f"var rel err {ev:.3e}")
    if not (bool(torch.isfinite(mean_e).all()) and bool((var_e > 0).all())):
        raise AssertionError("extended predictive not finite / variances not positive")
    for i, what in enumerate(("mean", "var")):
        bar = 2.0 * max(errs["plain fp32"][i], 1e-6)
        if not errs["extend"][i] <= bar:
            raise AssertionError(f"extended {what} error {errs['extend'][i]:.3e} above 2x "
                                 f"a fresh fp32 fit's ({bar:.3e})")

    path = REPO / "build" / "chip_smoke" / "extended.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    ext.save(str(path))
    back = FittedSPR.load(str(path), _model(x_all, y_all, y_mean, y_std, fused=True,
                                            dtype=torch.float32))
    more = [torch.as_tensor(a, device="cuda") for a in (x_more, y_more)]
    again, direct = back.extend(*more), ext.extend(*more)
    unequal = [k for k in direct.state if not torch.equal(again.state[k], direct.state[k])]
    print(f"[extend] saved, reloaded and extended by {EXTEND_M} more: "
          f"{'bitwise equal' if not unequal else f'differs in {unequal}'}")
    if unequal:
        raise AssertionError(f"reloaded extension differs in {unequal}")
    return dict(extend_ms=t_ext * 1e3, refit_ms=t_refit * 1e3, errs=errs)


def _minima(log_path):
    """reg fd's final two lines: [(cell, NLL) of Student-t, of Gaussian]."""
    text = Path(log_path).read_text()
    if "Traceback" in text:
        raise AssertionError(f"{log_path}:\n{text}")
    return [(cell, float(v)) for cell, v in
            (line.rsplit(": ", 1) for line in text.strip().splitlines()[-2:])]


def phase19_find_and_add_x():
    """``reg fd`` on syn-normal over FD_GRID on the card and on the CPU
    (gate: the best Student-t and Gaussian NLLs within CLI_RTOL), then
    ``reg pr --add-x / --add-y`` on phase 3's checkpoint and its cached,
    not extendable, fitted state on the card."""
    work = REPO / "build" / "chip_smoke" / "find"
    shutil.rmtree(work, ignore_errors=True)
    minima, times = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _run_cli(["--device", device, "reg", "fd", *FD_GRID, "-dr", str(work / "data"),
                  "-cd", str(work / device)])
        times[device] = time.perf_counter() - t0
        minima[device] = _minima(work / device / "train.log")
    print(f"[fd] syn-normal 12 cells: {times['cuda']:.2f} s (cuda) {times['cpu']:.2f} s (cpu); "
          f"best t {minima['cuda'][0]} (cpu {minima['cpu'][0]}); best gaussian "
          f"{minima['cuda'][1]} (cpu {minima['cpu'][1]})")
    for (_, got), (_, want) in zip(minima["cuda"], minima["cpu"]):
        if not math.isfinite(got):
            raise AssertionError("reg fd: non-finite best NLL")
        np.testing.assert_allclose(got, want, rtol=CLI_RTOL)

    ckpt = REPO / "build" / "chip_smoke" / "syn-t-tp"
    rng = np.random.RandomState(19)
    add_x, add_y = work / "add_x.npy", work / "add_y.npy"
    np.save(add_x, rng.randn(20, 1).astype(np.float32))
    np.save(add_y, rng.randn(20).astype(np.float32))
    t0 = time.perf_counter()
    _run_cli(["--device", "cuda", "reg", "pr", "-cd", str(ckpt), "-dr",
              str(REPO / "build" / "chip_smoke" / "data"), "-fs", str(ckpt / "fitted.npz"),
              "-ax", str(add_x), "-ay", str(add_y), "-o", str(work / "added.npz"), "-q"])
    wall = time.perf_counter() - t0
    log = (ckpt / "predict" / "predict.log").read_text()
    nll = _nll(ckpt / "predict" / "predict.log")
    preds = np.load(work / "added.npz")
    print(f"[fd] reg pr --add-x 20 points on phase 3's cache: {wall:.2f} s, NLL {nll:.5f}")
    for want in ("refitting with extendable=True", "refreshed",
                 "extended conditioning set by 20"):
        if want not in log:
            raise AssertionError(f"reg pr --add-x: no {want!r} in\n{log}")
    if not (math.isfinite(nll) and np.all(np.isfinite(preds["mean"]))
            and np.all(preds["var"] > 0)):
        raise AssertionError("reg pr --add-x: non-finite NLL or predictions")
    return dict(fd_s=times, minima=minima)


def phase20_mlp_classifier():
    """SNNGPClassifier(network="mlp") on a seeded tabular set (MLP_CLS_N x
    MLP_CLS_D, 3 classes) for one epoch on the card, then predict_proba
    (gate: finite losses, probabilities that sum to 1)."""
    from snngp_torch.ops import gram as G
    from snngp_torch.sklearn import SNNGPClassifier

    rng = np.random.RandomState(20)
    y = rng.randint(3, size=MLP_CLS_N)
    x = (rng.randn(MLP_CLS_N, MLP_CLS_D) + 0.3 * y[:, None]).astype(np.float32)
    before = G.LAUNCHES["gram"]
    clf = SNNGPClassifier(method="svtp", network="mlp", num_hiddens=DEPTH, num_inducing=60,
                          num_samples=SVSP_SAMPLES, batch_size=SVSP_NB, epochs=1,
                          device="cuda")
    _, t_fit = _timed(lambda: clf.fit(x, y))
    proba = clf.predict_proba(x[:100])
    print(f"[mlp-cls] {MLP_CLS_N} x {MLP_CLS_D}, 3 classes, svtp depth {DEPTH}: one epoch "
          f"{t_fit:.2f} s, losses {np.round(clf.losses_, 5).tolist()}, accuracy "
          f"{clf.score(x, y):.3f}, K1 launches {G.LAUNCHES['gram'] - before}")
    if not np.all(np.isfinite(clf.losses_)):
        raise AssertionError(f"MLP classifier losses {clf.losses_}")
    if not (proba.shape == (100, 3) and np.allclose(proba.sum(axis=1), 1.0, rtol=1e-5)):
        raise AssertionError("MLP classifier probabilities")
    return dict(fit_s=t_fit)


# -- classification -----------------------------------------------------------------

def _svsp_data():
    """synthetic32 (CIFAR's 32 x 32 x 3, 10 classes) as ``cls tr`` loads it,
    and its class-proportional 200 inducing images."""
    from snngp_torch.cli.classification import _inducing_init
    from snngp_torch.data.classification import get_train_dataset

    (x, y), _, (num_class, _, _) = get_train_dataset("synthetic32", seed=10)
    z, _ = _inducing_init(x, y, num_class, SVSP_NI)
    return x, y, z, num_class


def _svsp_model(method, z, num_class, *, network="cnn", plain=False, dtype=None, eps=1e-6,
                trainable_inputs=True):
    """The CLI's model (``cls tr`` defaults: depth 4 relu CNN or WideResNet,
    or Myrtle-5; w_std 1, b_std 1e-8, a = b = 2), on the kernels or on the
    plain layer tier (Myrtle: K7's plain versions, scalar-only gradients)."""
    import torch
    from snngp_torch.cli.classification import _make_model
    from snngp_torch.nn import arch, layers
    from snngp_torch.ops import myrtle_gram as MG

    depth = MYRTLE_DEPTH if network == "myrtle" else SVSP_DEPTH
    get_kernel_fn = None
    if plain and network == "myrtle":
        def get_kernel_fn(w, b, last):
            def kernel_fn(x1, x2=None, get="nngp"):
                x2e = x1 if x2 is None else x2
                return MG._MyrtleGram.apply(x1, x2e, w, b, last, depth, "relu", False,
                                            x2e is x1, True)
            return kernel_fn
    elif plain:
        builder = arch.get_cnn_layer if network == "cnn" else arch.get_conv_resnet_layer

        def get_kernel_fn(w, b, last):
            return layers.kernel_fn_of(builder(SVSP_DEPTH, num_class, "relu", w, b, last))
    model = _make_model(method, network, depth, "relu", 1.0, 1e-8, 1.0, 2.0, 2.0,
                        num_class, z, eps, get_kernel_fn=get_kernel_fn,
                        trainable_inputs=trainable_inputs)
    return model.to(device="cuda", dtype=dtype or torch.float32)


def _svsp_draws(method, num_class, nb=SVSP_NB):
    """One set of standard variates for the correlated ELBO draws, in float64
    (cast per model): normals, and for svtp gamma(a = 2) variates."""
    import torch
    from snngp_torch.ops.mvt import draw_t

    gen = torch.Generator(device="cuda").manual_seed(21)
    shape = (SVSP_SAMPLES, num_class, nb)
    like = dict(dtype=torch.float64, device="cuda")
    if method == "svgp":
        return torch.randn(shape, generator=gen, **like)
    return draw_t(torch.tensor(4.0, **like), shape, gen, **like)


def _cast_draws(draws, dtype):
    from snngp_torch.ops.mvt import TDraws
    if isinstance(draws, TDraws):
        return TDraws(*(t.to(dtype) for t in draws))
    return draws.to(dtype)


def _svsp_gradient_check(method, x, y, z, num_class, network="cnn", nb=SVSP_NB):
    """The ELBO's gradients on one batch through the kernels (fp32) and
    through the plain layer tier (fp32 and float64), on the same draws;
    gate: the kernel path's error against float64 within 2x the plain fp32
    path's (floor 1e-6). eps = 1e-2 keeps the inducing Gram's inverse well
    conditioned, so the comparison reads the Gram paths, not the float64
    pseudo-inverse floor."""
    import torch

    draws = _svsp_draws(method, num_class, nb)
    grads, losses = {}, {}
    for name, plain, dtype in (("kernel", False, torch.float32),
                               ("plain fp32", True, torch.float32),
                               ("plain fp64", True, torch.float64)):
        torch.cuda.reset_peak_memory_stats()
        model = _svsp_model(method, z, num_class, network=network, plain=plain, dtype=dtype,
                            eps=1e-2)
        xb = torch.as_tensor(x[:nb], device="cuda", dtype=dtype)
        yb = torch.as_tensor(y[:nb], device="cuda")
        loss = model.loss(xb, yb, x.shape[0], SVSP_SAMPLES, draws=_cast_draws(draws, dtype))
        loss.backward()
        params = sorted(model.named_parameters())
        grads[name] = {n: p.grad.double().flatten() for n, p in params}
        losses[name] = loss.item()
        print(f"[svsp] {network} {method} {name:10s} loss {loss.item():.8f}  peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, loss
        torch.cuda.empty_cache()
    g64 = torch.cat(list(grads["plain fp64"].values()))
    errs = {}
    for name in ("kernel", "plain fp32"):
        g = torch.cat(list(grads[name].values()))
        errs[name] = ((g - g64).norm() / g64.norm()).item()
        per = {n: ((grads[name][n] - grads["plain fp64"][n]).norm()
                   / grads["plain fp64"][n].norm()).item() for n in grads[name]}
        print(f"[svsp] {network} {method} {name:10s} gradient rel err vs fp64 {errs[name]:.3e}; "
              + " ".join(f"{n} {v:.1e}" for n, v in per.items()))
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{method}: non-finite ELBO {losses}")
    if not errs["kernel"] <= 2.0 * max(errs["plain fp32"], 1e-6):
        raise AssertionError(f"{method}: kernel-path gradient error {errs['kernel']:.3e} "
                             f"above 2x the plain fp32 error {errs['plain fp32']:.3e}")
    return dict(errs=errs, g64=g64)


def _svsp_stepper(method, x, y, z, num_class, trainable_inputs, network="cnn", mesh=None):
    """A fresh model and a function taking one ELBO step as ``cls tr`` takes
    it (its batches, masks and Adam; svtp trains with last_w_std frozen),
    the batch's Gram blocks sharded over ``mesh`` when one is given."""
    import argparse
    import torch
    from snngp_torch.cli.classification import _optimizers
    from snngp_torch.utils import DataLoader, svsp_train_step

    model = _svsp_model(method, z, num_class, network=network,
                        trainable_inputs=trainable_inputs)
    opts = _optimizers(model, argparse.Namespace(optimizer="adam", lr2=None, method=method,
                                                 freeze_inducing=not trainable_inputs,
                                                 network=network))
    gen = torch.Generator(device="cuda").manual_seed(10)
    batches = iter(DataLoader(x, y, batch_size=SVSP_NB, shuffle=True, seed=10))

    def step(prof=None):
        xb, yb = next(batches)
        return svsp_train_step(model, opts, [1e-2],
                               torch.as_tensor(xb.astype(np.float32), device="cuda"),
                               torch.as_tensor(yb, device="cuda"), x.shape[0],
                               SVSP_SAMPLES, gen, prof, mesh=mesh)

    return step


def _svsp_steps(label, method, x, y, z, num_class, want, trainable_inputs=True,
                network="cnn", steps=SVSP_STEPS, mesh=None):
    """``steps`` timed ELBO steps after one untimed one; ``want`` maps each
    kernel to its launches a step (every other kernel: none). Returns the
    per-step phase times (ms)."""
    import torch
    from snngp_torch.utils import Profiler

    step = _svsp_stepper(method, x, y, z, num_class, trainable_inputs, network, mesh)
    step()
    _sync()
    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    prof = Profiler()
    t0 = time.perf_counter()
    losses = [step(prof) for _ in range(steps)]
    _sync()
    wall = (time.perf_counter() - t0) / steps * 1e3
    launched = {k: v - before[k] for k, v in _launches().items()}
    losses = torch.stack(losses).tolist()
    per_step = {k: 1e3 * v / steps for k, v in prof.totals.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[svsp] {label}: {steps} steps, losses "
          + " ".join(f"{v:.4f}" for v in losses))
    print(f"[svsp] {label}: step {wall:.2f} ms (synchronized phases): "
          + "  ".join(f"{k} {v:.2f} ms" for k, v in per_step.items())
          + f"; peak {peak:.2f} GiB; launches {launched}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    expected = {k: want.get(k, 0) * steps for k in launched}
    if launched != expected:
        raise AssertionError(f"{label}: launched {launched}; expected {want} a step")
    return dict(step_ms=wall, phases_ms=per_step, peak_gib=peak, losses=losses)


def phase9_svsp_gradients():
    """Phase 9's comparison, run before its launch window: the ELBO's
    gradient on one batch against float64 for svgp and svtp."""
    x, y, z, num_class = _svsp_data()
    return {m: _svsp_gradient_check(m, x, y, z, num_class) for m in ("svgp", "svtp")}


def phase9_svsp():
    """SVSP at full width on the card: synthetic32 (32 x 32 x 3), 200
    inducing images, batches of 100, depth 4 relu (``cls tr`` defaults):
    SVSP_STEPS timed ELBO steps each of svgp, svtp and svtp with frozen
    inducing inputs (the scalar-only backward, K4)."""
    x, y, z, num_class = _svsp_data()
    configs = (("svgp", "svgp", True), ("svtp", "svtp", True), ("svtp frozen", "svtp", False))
    steps = {label: _svsp_steps(label, method, x, y, z, num_class,
                                {"conv_gram": 3, "conv_gram_grads": 0 if trainable else 3},
                                trainable)
             for label, method, trainable in configs}
    # Profiled after all the timed steps, so that no timing carries profiler overhead.
    for label, method, trainable in configs:
        _profile(_svsp_stepper(method, x, y, z, num_class, trainable),
                 f"one {label} ELBO step", top=10)
    return steps


def _cls_nll(log_dir):
    (name,) = [p for p in Path(log_dir).iterdir() if p.suffix == ".log"]
    return _nll(name)


def _mc_tolerance(ckpt, num_data, num_samples):
    """5 standard errors of the difference of two independent MC test NLLs
    of this checkpoint: per image, log mean_s p_s has standard error
    sd_s(p_s) / (sqrt(S) mean_s(p_s)) (delta method), estimated here from
    the card's own draws; plus 1e-4 for the fp32 paths of two devices."""
    import argparse
    import torch
    from snngp_torch.cli.classification import _resize_to_inducing, _restore_svsp
    from snngp_torch.data.classification import get_test_dataset
    from snngp_torch.models import fit_svsp

    (x, y), (num_class, _) = get_test_dataset("synthetic32", num_data=num_data)
    ns = argparse.Namespace(ckpt_dir=str(ckpt), ckpt_index=None, device=torch.device("cuda"))
    model, _ = _restore_svsp(ns, num_class)
    x = _resize_to_inducing(x, model)
    gen = torch.Generator(device="cuda").manual_seed(3)
    var_sum = 0.0
    with torch.no_grad():
        fitted = fit_svsp(model)
        for lo in range(0, x.shape[0], SVSP_NB):
            xb = torch.as_tensor(x[lo:lo + SVSP_NB].astype(np.float32), device="cuda")
            yb = torch.as_tensor(y[lo:lo + SVSP_NB], device="cuda")
            f = fitted._sample(xb, num_samples, gen, None)             # [C, B, S]
            p = torch.softmax(f.double(), dim=0).gather(
                0, yb[None, :, None].expand(1, -1, num_samples))[0]   # [B, S]
            se = p.std(dim=1) / (math.sqrt(num_samples) * p.mean(dim=1))
            var_sum += float((se * se).sum())
    return 5.0 * math.sqrt(2.0 * var_sum) / x.shape[0] + 1e-4


def phase10_cls_cli():
    """``cls tr -m svtp -dn synthetic32 -e 1`` at -ni 200 -nb 100 -nh 4 on the
    card (and once more with --freeze-inducing, the K4 path), then ``cls ts``
    on the card and on the CPU and ``cls pr`` on its checkpoint, and one
    timed FittedSVSP request of 100 images at 10,000 samples."""
    import argparse
    import torch
    from snngp_torch.cli.classification import _resize_to_inducing, _restore_svsp
    from snngp_torch.data.classification import get_test_dataset
    from snngp_torch.models import fit_svsp

    work = REPO / "build" / "chip_smoke" / "cls"
    shutil.rmtree(work, ignore_errors=True)
    train = ["cls", "tr", "-m", "svtp", "-dn", "synthetic32", "-e", "1", "-ni", str(SVSP_NI),
             "-nb", str(SVSP_NB), "-nh", str(SVSP_DEPTH), "-cr", str(work), "-q"]
    times = {}
    for name, extra in (("cuda", []), ("frozen", ["--freeze-inducing"])):
        t0 = time.perf_counter()
        _run_cli(["--device", "cuda", *train, "-cn", name, *extra])
        times[name] = time.perf_counter() - t0
        text = (work / name / "train.log").read_text()
        if "Traceback" in text:
            raise AssertionError(text)
        lines = [ln for ln in text.splitlines() if ln.startswith("[") and "NLL:" in ln]
        print(f"[cls] cls tr {name}: {times[name]:.2f} s; " + " | ".join(lines[-3:]))
    ckpt = work / "cuda"
    test = ["-dn", "synthetic32", "-cd", str(ckpt), "-nd", str(CLS_TEST_N), "-q"]
    nll = {}
    for device in ("cuda", "cpu"):
        shutil.rmtree(ckpt / "test", ignore_errors=True)
        t0 = time.perf_counter()
        _run_cli(["--device", device, "cls", "ts", *test])
        nll[device] = _cls_nll(ckpt / "test")
        times[f"ts {device}"] = time.perf_counter() - t0
    _run_cli(["--device", "cuda", "cls", "pr", *test])
    nll["pr"] = _nll(ckpt / "predict" / "predict.log")
    tol = _mc_tolerance(ckpt, CLS_TEST_N, 10_000)
    print(f"[cls] cls ts NLL cuda {nll['cuda']:.5f} ({times['ts cuda']:.2f} s) cpu "
          f"{nll['cpu']:.5f} ({times['ts cpu']:.2f} s), |diff| {abs(nll['cuda'] - nll['cpu']):.2e}"
          f" (MC tolerance {tol:.2e}); cls pr NLL {nll['pr']:.5f}")
    if not all(math.isfinite(v) for v in nll.values()):
        raise AssertionError(f"non-finite NLL {nll}")
    if not abs(nll["cuda"] - nll["cpu"]) <= tol:
        raise AssertionError(f"cls ts: CUDA and CPU NLLs differ beyond MC error ({tol:.2e})")
    np.testing.assert_allclose(nll["pr"], nll["cuda"], rtol=1e-4)

    (x, _), (num_class, _) = get_test_dataset("synthetic32", num_data=SVSP_NB)
    ns = argparse.Namespace(ckpt_dir=str(ckpt), ckpt_index=None, device=torch.device("cuda"))
    model, _ = _restore_svsp(ns, num_class)
    xb = torch.as_tensor(_resize_to_inducing(x, model), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        fitted = fit_svsp(model)
        lat = []
        for _ in range(4):
            _sync()
            t0 = time.perf_counter()
            proba = fitted.predict_proba(xb, 10_000, generator=gen)
            _sync()
            lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[cls] FittedSVSP request ({SVSP_NB} images, 10,000 samples): "
          + " ".join(f"{v:.2f} ms" for v in lat) + " (first one warms up)")
    if proba.shape != (SVSP_NB, num_class) or not bool(torch.isfinite(proba).all()):
        raise AssertionError(f"predict_proba: shape {tuple(proba.shape)} / not finite")
    return dict(nll=nll, tol=tol, times=times, request_ms=lat)


# -- K5 and K6 (WideResNet) -------------------------------------------------------------

def k5_ops(n1, n2, hw, nblocks, act, mismatch, same):
    """fp32 operations of K5 on these shapes (see _dual_act_ops): per pixel
    and block two dual activations, two stencils (4 adds and a divide
    each), the FMA of c1 and the residual update (an FMA and an add); a
    conv shortcut adds a third stencil, its FMA and an add."""
    a = _dual_act_ops(act, False)
    return _pairs(n1, n2, same) * hw * (nblocks * (2 * a + 15) + (7 if mismatch else 0))


def k6_ops(n1, n2, h, w, act, same):
    """fp32 operations of K6 on these shapes: t1 at every full-resolution
    pixel; the column sums of t1 and of k at the lattice columns (2 adds
    each); at each reduced pixel the two lattice row sums with their
    divides (3 each) and FMAs, t2, the reduced stencil (5), its FMA and the
    final add."""
    a = _dual_act_ops(act, False)
    hr, wr = -(-h // 2), -(-w // 2)
    return _pairs(n1, n2, same) * (h * w * a + 4 * h * wr + hr * wr * (a + 18))


def _resnet_cases():
    """The K5 and K6 comparisons: (kernel, label, n1, n2, h, w, same,
    nblocks, mismatch, act). K5 on the three Gram blocks of an SVSP step at
    32 x 32 (group 1: four blocks, the first with a conv shortcut), three
    blocks at 16 x 16, 8 x 8 and 4 x 4 (groups 2-4), erf, a ragged 7 x 7
    and a state wider than 32 (streamed transposed); K6 at each group
    boundary (32 -> 16, 16 -> 8, 8 -> 4), erf, the odd and rectangular
    7 x 7 and 6 x 10, and a state wider than 32 (streamed transposed), on
    distinct operands and on identical ones."""
    k5 = [("100x200 32x32 4 blocks+sc", 100, 200, 32, 32, False, 4, True, "relu"),
          ("200x200 32x32 4 blocks+sc sym", 200, 200, 32, 32, True, 4, True, "relu"),
          ("100x100 32x32 4 blocks+sc sym", 100, 100, 32, 32, True, 4, True, "relu"),
          ("200x200 32x32 4 blocks+sc sym", 200, 200, 32, 32, True, 4, True, "erf"),
          ("200x200 16x16 3 blocks sym", 200, 200, 16, 16, True, 3, False, "relu"),
          ("100x200 16x16 3 blocks", 100, 200, 16, 16, False, 3, False, "erf"),
          ("200x200 8x8 3 blocks sym", 200, 200, 8, 8, True, 3, False, "relu"),
          ("200x200 4x4 3 blocks sym", 200, 200, 4, 4, True, 3, False, "relu"),
          ("64x96 7x7 2 blocks+sc", 64, 96, 7, 7, False, 2, True, "relu"),
          ("40x50 5x64 2 blocks+sc", 40, 50, 5, 64, False, 2, True, "relu")]
    k6 = [("200x200 32->16 sym", 200, 200, 32, 32, True, "relu"),
          ("100x200 32->16", 100, 200, 32, 32, False, "relu"),
          ("200x200 32->16 sym", 200, 200, 32, 32, True, "erf"),
          ("200x200 16->8 sym", 200, 200, 16, 16, True, "relu"),
          ("200x200 8->4 sym", 200, 200, 8, 8, True, "relu"),
          ("64x96 7x7->4x4", 64, 96, 7, 7, False, "relu"),
          ("64x96 6x10->3x5", 64, 96, 6, 10, False, "erf"),
          ("40x50 5x64->3x32", 40, 50, 5, 64, False, "relu"),
          ("50x50 5x64->3x32 sym", 50, 50, 5, 64, True, "erf")]
    return ([("K5", *c) for c in k5]
            + [("K6", label, n1, n2, h, w, same, 1, True, act)
               for label, n1, n2, h, w, same, act in k6])


def _resnet_inputs(rng, n1, n2, h, w, same):
    """A matched-pixel state and its variance maps as the glue makes them:
    the input moment and the initial conv of random 3-channel images."""
    import torch
    from snngp_torch.ops import resnet_conv_gram as RG

    x1, x2 = _conv_inputs(rng, n1, n2, h, w, 3, same)
    w2, b2 = (torch.tensor(v * v, device="cuda") for v in (W_STD, B_STD))
    k, v1, v2 = RG._front(x1, x2, w2, b2, same)
    return k.reshape(n1, n2, h * w).contiguous(), v1, v2


def _resnet_kernel_args(kernel, k, v1, v2, same, nblocks, mismatch, act):
    """The kernel's variance rows and scales; returns (args, kwargs)."""
    import torch
    from snngp_torch.ops import resnet_conv_gram as RG

    w, b = (torch.tensor(v, device="cuda") for v in (W_STD, B_STD))
    h, wd = v1.shape[1:]
    scales = torch.stack([w * w, b * b])
    if kernel == "K5":
        s1, _ = RG.tail_var_stack(v1, nblocks, act, w, b, mismatch)
        s2 = s1 if same else RG.tail_var_stack(v2, nblocks, act, w, b, mismatch)[0]
        return ((k, RG._flat(s1), RG._flat(s2), scales),
                dict(nblocks=nblocks, act=act, h=h, w=wd, mismatch=mismatch))
    m1, _ = RG.strided_var_pieces(v1, act, w, b)
    m2 = m1 if same else RG.strided_var_pieces(v2, act, w, b)[0]
    return ((k, (RG._flat(v1), RG._flat(m1)), (RG._flat(v2), RG._flat(m2)), scales),
            dict(act=act, h=h, w=wd))


def phase11_k5_k6_vs_plain():
    """K5 and K6 against their plain versions on the same inputs; gate:
    max|K_kernel - K_plain| / max|K_plain| <= 1e-5; a second launch gives
    the same bits; identical operands (a symmetric launch) give a bitwise
    symmetric K."""
    import torch
    from snngp_torch.ops import resnet_conv_gram as RG

    rng = np.random.RandomState(11)
    rows = {"K5": {}, "K6": {}}
    worst = {"K5": 0.0, "K6": 0.0}
    for kernel, label, n1, n2, h, w, same, nblocks, mismatch, act in _resnet_cases():
        k, v1, v2 = _resnet_inputs(rng, n1, n2, h, w, same)
        args, kw = _resnet_kernel_args(kernel, k, v1, v2, same, nblocks, mismatch, act)
        cuda_fn, plain_fn = ((RG.resnet_tail_cuda, RG.resnet_tail_plain) if kernel == "K5"
                             else (RG.strided_cuda, RG.strided_block_plain))
        cuda_fn = functools.partial(cuda_fn, same=same)
        k_kernel = cuda_fn(*args, **kw)
        repeat = torch.equal(k_kernel, cuda_fn(*args, **kw))
        k_plain = plain_fn(*args, **kw)
        _sync()
        abs_err = (k_kernel - k_plain).abs().max().item()
        rel_err = abs_err / k_plain.abs().max().item()
        finite = bool(torch.isfinite(k_kernel).all())
        sym = ((k_kernel - k_kernel.transpose(0, 1)).abs().max().item() if same
               else float("nan"))
        ms = _time_ms(lambda: cuda_fn(*args, **kw))
        plain_ms = _time_ms(lambda: plain_fn(*args, **kw), reps=2)
        # The state: K(x, x)'s function needs one triangle of it.
        rows_in = list(args[1:3]) if kernel == "K5" else [*args[1], *args[2]]
        nbytes = (_pairs(n1, n2, same) * h * w * 4 + _read_bytes([*rows_in, args[3]])
                  + k_kernel.numel() * 4)
        ops = (k5_ops(n1, n2, h * w, nblocks, act, mismatch, same) if kernel == "K5"
               else k6_ops(n1, n2, h, w, act, same))
        bound, by = bound_ms(nbytes, ops)
        print(f"[{kernel}] {act:4s} {label:30s} rel_err {rel_err:.3e} abs_err {abs_err:.3e}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bound:.3f} ms ({by}, "
              f"{100 * bound / ms:.2f}%)  repeat {repeat}  max|K-K^T| {sym:.3e}")
        if not finite or not rel_err <= KERNEL_REL_TOL or not repeat:
            raise AssertionError(f"{kernel} {act} at {label}: rel_err {rel_err:.3e} "
                                 f"(tol {KERNEL_REL_TOL}), finite={finite}, repeat={repeat}")
        if same and sym != 0.0:
            raise AssertionError(f"{kernel} {act} at {label}: K(x, x) not symmetric ({sym})")
        worst[kernel] = max(worst[kernel], abs_err)
        rows[kernel][f"{act}/{label}"] = dict(ms=ms, plain_ms=plain_ms, rel_err=rel_err,
                                              abs_err=abs_err, bound_ms=bound, bound_by=by)
        del k_kernel, k_plain, args, k, v1, v2
    torch.cuda.empty_cache()
    return rows, worst


def phase12_resnet_gradient():
    """Phase 12's comparison, run before its launch window: the WideResNet
    svgp ELBO's gradient on one batch against float64."""
    x, y, z, num_class = _svsp_data()
    return _svsp_gradient_check("svgp", x, y, z, num_class, network="resnet")


def phase12_resnet_svsp():
    """WideResNet SVSP at full width on the card (phase 9's shape, ``-n
    resnet``): SVSP_STEPS timed svgp ELBO steps with trainable and with
    frozen inducing inputs (the same layer-tier recompute, for the three
    scales only), then one profiled step of each."""
    x, y, z, num_class = _svsp_data()
    # A Gram block: one K5 for group 1, and for each of groups 2-4 one K6
    # and (depth > 1) one K5; three blocks a step.
    want = {"resnet_tail": 3 * (1 + 3 * (SVSP_DEPTH > 1)), "resnet_strided": 9}
    configs = (("resnet svgp", "svgp", True), ("resnet svgp frozen", "svgp", False))
    steps = {label: _svsp_steps(label, method, x, y, z, num_class, want, trainable,
                                network="resnet")
             for label, method, trainable in configs}
    for label, method, trainable in configs:
        _profile(_svsp_stepper(method, x, y, z, num_class, trainable, network="resnet"),
                 f"one {label} ELBO step", top=10)
    return steps


def phase13_resnet_cli():
    """``cls tr -n resnet -m svtp -dn synthetic32 -e 1`` at -ni 200 -nb 100
    -nh 4 on the card, then ``cls ts`` on the card and on the CPU and ``cls
    pr`` on its checkpoint."""
    work = REPO / "build" / "chip_smoke" / "cls_resnet"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    _run_cli(["--device", "cuda", "cls", "tr", "-m", "svtp", "-n", "resnet", "-dn",
              "synthetic32", "-e", "1", "-ni", str(SVSP_NI), "-nb", str(SVSP_NB), "-nh",
              str(SVSP_DEPTH), "-cr", str(work), "-cn", "cuda", "-q"])
    times = {"tr": time.perf_counter() - t0}
    ckpt = work / "cuda"
    text = (ckpt / "train.log").read_text()
    if "Traceback" in text:
        raise AssertionError(text)
    lines = [ln for ln in text.splitlines() if ln.startswith("[") and "NLL:" in ln]
    print(f"[cls-resnet] cls tr: {times['tr']:.2f} s; " + " | ".join(lines[-3:]))
    test = ["-dn", "synthetic32", "-cd", str(ckpt), "-nd", str(RESNET_TEST_N), "-q"]
    nll = {}
    for device in ("cuda", "cpu"):
        shutil.rmtree(ckpt / "test", ignore_errors=True)
        t0 = time.perf_counter()
        _run_cli(["--device", device, "cls", "ts", *test])
        nll[device] = _cls_nll(ckpt / "test")
        times[f"ts {device}"] = time.perf_counter() - t0
    _run_cli(["--device", "cuda", "cls", "pr", *test])
    nll["pr"] = _nll(ckpt / "predict" / "predict.log")
    tol = _mc_tolerance(ckpt, RESNET_TEST_N, 10_000)
    print(f"[cls-resnet] cls ts NLL cuda {nll['cuda']:.5f} ({times['ts cuda']:.2f} s) cpu "
          f"{nll['cpu']:.5f} ({times['ts cpu']:.2f} s), |diff| "
          f"{abs(nll['cuda'] - nll['cpu']):.2e} (MC tolerance {tol:.2e}); cls pr NLL "
          f"{nll['pr']:.5f}")
    if not all(math.isfinite(v) for v in nll.values()):
        raise AssertionError(f"non-finite NLL {nll}")
    if not abs(nll["cuda"] - nll["cpu"]) <= tol:
        raise AssertionError(f"resnet cls ts: CUDA and CPU NLLs differ beyond MC error "
                             f"({tol:.2e})")
    np.testing.assert_allclose(nll["pr"], nll["cuda"], rtol=1e-4)
    return dict(nll=nll, tol=tol, times=times)


# -- K7 (Myrtle) ----------------------------------------------------------------------

def k7_ops(n1, n2, h, c, depth, act, same, tangents=0):
    """(fp32, fp64) operations of K7 (or of its tangent mode carrying
    ``tangents`` of them) on these shapes, counted from csrc/myrtle_gram.cu
    (see _dual_act_ops): per stage-1 entry the moment (C FMAs and a scale)
    and the pool (its add into the partial sum and a share of the
    contribution's FMA: 2); per entry and conv the stencil's 4 adds and
    divide for each state, the Dense FMA and the dual activation (or its
    partials and, per tangent, the du update (3) and the tangent's two FMAs
    and a product (5)); per stage-2 entry the pool again; the GAP adds one
    fp64 add per stage-3 entry and state."""
    from snngp_torch.ops.myrtle_gram import MYRTLE_GROUPS

    g0, g1, g2 = MYRTLE_GROUPS[depth]
    ns = 1 + tangents
    act_ops = _dual_act_ops(act, tangents > 0)
    conv = 5 * ns + 2 + act_ops + 8 * tangents
    e1, e2, e3 = h ** 4, (h // 2) ** 4, (h // 4) ** 4
    per = e1 * (2 * c + 1) + 2 * ns * (e1 + e2) + conv * (g0 * e1 + g1 * e2 + g2 * e3)
    pairs = _pairs(n1, n2, same)
    return pairs * per, pairs * ns * e3


K7_HEAD = "relu/200x200 32x32x3 myrtle-5 sym"


def _myrtle_args(x1, x2, depth, act, tangents):
    """The kernels' inputs: packed profiles (and their tangents), scales."""
    import torch
    from snngp_torch.ops import myrtle_gram as MG

    w, b, last = (torch.tensor(v, device="cuda") for v in (W_STD, B_STD, LAST_W_STD))
    inv_c = torch.tensor(1.0 / x1.shape[-1], device="cuda")
    groups = MG.MYRTLE_GROUPS[depth]
    if not tangents:
        p1 = MG.pack_profiles(MG.myrtle_var_profiles(x1, groups, act, w, b))
        p2 = p1 if x2 is x1 else MG.pack_profiles(MG.myrtle_var_profiles(x2, groups, act, w, b))
        return (x1, x2, p1, p2, torch.stack([w * w, b * b, last * last, inv_c]))
    pr1 = MG._profiles_with_tangents(x1, groups, act, w, b)
    p1, d1 = MG.pack_profiles(pr1[0]), MG.pack_profiles(pr1[1])
    if x2 is x1:
        p2, d2 = p1, d1
    else:
        pr2 = MG._profiles_with_tangents(x2, groups, act, w, b)
        p2, d2 = MG.pack_profiles(pr2[0]), MG.pack_profiles(pr2[1])
    return (x1, x2, p1, p2, d1, d2, torch.stack([w * w, b * b, last * last, inv_c, w, b]))


def _k7_cases():
    """(label, n1, n2, h, same, depth, act, tangents, vs_fp64): every depth
    and act at 8 x 8, 16 x 16 and 32 x 32 (rectangular and ragged, or
    symmetric), and the tangent modes w, b, wb (at 32 x 32, wb only: the
    plain versions take ~8 s a call there), with a ragged symmetric wb case
    in erf and in relu (the latter held against float64, ``vs_fp64``)."""
    cases = []
    for h, (n1, n2) in ((8, (9, 13)), (16, (5, 7)), (32, (3, 5))):
        for depth in (5, 7, 10):
            for act in ("relu", "erf"):
                same = depth == 7
                cases.append((f"{n1}x{n1 if same else n2} {h}x{h}x3 myrtle-{depth}"
                              + (" sym" if same else ""), n1, n1 if same else n2, h, same,
                              depth, act, "", False))
    for label, n1, n2, h, same, depth, act, modes in (
            ("6x10 8x8x3 myrtle-10", 6, 10, 8, False, 10, "erf", ("wb", "w", "b")),
            ("5x7 16x16x3 myrtle-5", 5, 7, 16, False, 5, "relu", ("wb", "w", "b")),
            ("7x7 16x16x3 myrtle-7 sym", 7, 7, 16, True, 7, "erf", ("wb",)),
            ("7x7 16x16x3 myrtle-7 sym", 7, 7, 16, True, 7, "relu", ("wb",)),
            ("4x4 32x32x3 myrtle-5 sym", 4, 4, 32, True, 5, "relu", ("wb",)),
            ("3x5 32x32x3 myrtle-7", 3, 5, 32, False, 7, "erf", ("wb",))):
        for mode in modes:
            cases.append((label, n1, n2, h, same, depth, act, mode,
                          act == "relu" and same and h == 16))
    return cases


def _k7_check(label, x1, x2, depth, act, mode, time_it=False, vs_fp64=False):
    """One K7 (or tangent-mode) call against its plain version; returns the
    row. Gate: max error <= 1e-5 of max |K| (per output: of max |dK| for a
    tangent), two launches give the same bits, and a symmetric launch of
    either mode (``same``: x2 is x1) gives bitwise symmetric K and
    tangents. ``vs_fp64`` (relu tangents on same-image pairs, which meet c
    = 1, where sqrt(1 - c^2) amplifies fp32 round-off) replaces the 1e-5
    gate: per output, the kernel's error against the plain version in
    float64 within 2x the plain fp32 version's (floor 1e-6), the bar of the
    gradient checks."""
    import torch
    from snngp_torch.ops import myrtle_gram as MG

    same = x2 is x1
    args = _myrtle_args(x1, x2, depth, act, bool(mode))
    if mode:
        kw = dict(depth=depth, act=act, tangents=mode)
        cuda_fn = functools.partial(MG.myrtle_gram_tangents_cuda, same=same)
        plain_fn = MG.myrtle_gram_tangents_plain
    else:
        kw = dict(depth=depth, act=act)
        cuda_fn = lambda *a, **k: (MG.myrtle_gram_cuda(*a, **k, same=same),)  # noqa: E731
        plain_fn = lambda *a, **k: (MG.myrtle_gram_plain(*a, **k),)  # noqa: E731
    # One call each is timed (each takes ~1-30 s at the head shape): the
    # kernel's second call, after the first as its warm-up, and the plain
    # version's only call.
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    got = cuda_fn(*args, **kw)
    events[0].record()
    again = cuda_fn(*args, **kw)
    events[1].record()
    events[2].record()
    want = plain_fn(*args, **kw)
    events[3].record()
    _sync()
    rels = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
    abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    sym = max((g - g.T).abs().max().item() for g in got) if same else float("nan")
    row = dict(rel_err=max(rels), abs_err=abs_err)
    timing = ""
    if time_it:
        row["ms"] = events[0].elapsed_time(events[1])
        row["plain_ms"] = events[2].elapsed_time(events[3])
        n1, n2, h, c = x1.shape[0], x2.shape[0], x1.shape[1], x1.shape[3]
        nbytes = (_read_bytes(args)
                  + 4 * sum(g.numel() for g in got))
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, *k7_ops(n1, n2, h, c, depth, act, same, len(mode)))
        timing = (f"  kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  bound "
                  f"{row['bound_ms']:.3f} ms ({row['bound_by']}, "
                  f"{100 * row['bound_ms'] / row['ms']:.2f}% of the kernel's time)")
    accurate = max(rels) <= KERNEL_REL_TOL
    fp64 = ""
    if vs_fp64:
        ref = plain_fn(*(a.double() for a in args), **kw)

        def rel64(outs):
            return [((o.double() - r).abs().max() / r.abs().max()).item()
                    for o, r in zip(outs, ref)]

        row["fp64_err"], row["plain_fp64_err"] = rel64(got), rel64(want)
        accurate = all(k <= 2.0 * max(p, 1e-6)
                       for k, p in zip(row["fp64_err"], row["plain_fp64_err"]))
        fp64 = ("  vs float64: kernel " + "/".join(f"{e:.2e}" for e in row["fp64_err"])
                + ", plain fp32 " + "/".join(f"{e:.2e}" for e in row["plain_fp64_err"]))
    print(f"[K7] {act:4s} {label:28s} {mode or 'fwd':3s} rel_err "
          + "/".join(f"{r:.2e}" for r in rels) + f" abs_err {abs_err:.3e}{timing}{fp64}"
          f"  repeat {repeat}  max|K-K^T| {sym:.3e}")
    symmetric = not same or sym == 0.0
    if not finite or not accurate or not repeat or not symmetric:
        bar = "2x the plain fp32 error vs float64" if vs_fp64 else KERNEL_REL_TOL
        raise AssertionError(f"K7 {act} {label} {mode or 'fwd'}: rel_err {rels}{fp64} (tol "
                             f"{bar}), finite={finite}, repeat={repeat}, "
                             f"max|K-K^T| {sym} (symmetric launch: 0)")
    return row


def phase14_k7_vs_plain():
    """K7 and its tangent mode against their plain versions (every depth and
    act at 8 x 8, 16 x 16 and 32 x 32; the w, b and wb modes), then both
    timed at the main-path shape: 200 x 200 pairs of 32 x 32 x 3 images,
    Myrtle-5, relu (K(Z, Z) of a Myrtle SVSP step). Two launches give the
    same bits; every symmetric launch of either mode gives bitwise
    symmetric K (and dK/dw, dK/db), gated."""
    import torch

    rng = np.random.RandomState(14)
    rows = {"fwd": {}, "tangents": {}}
    with torch.inference_mode():
        for label, n1, n2, h, same, depth, act, mode, vs_fp64 in _k7_cases():
            x1, x2 = _conv_inputs(rng, n1, n2, h, h, 3, same)
            rows["tangents" if mode else "fwd"][f"{act}/{label}/{mode or 'fwd'}"] = \
                _k7_check(label, x1, x2, depth, act, mode, vs_fp64=vs_fp64)
        x = torch.as_tensor(rng.randn(SVSP_NI, 32, 32, 3).astype(np.float32), device="cuda")
        rows["fwd"][K7_HEAD] = _k7_check(K7_HEAD[5:], x, x, 5, "relu", "", time_it=True)
        rows["tangents"][K7_HEAD] = _k7_check(K7_HEAD[5:], x, x, 5, "relu", "wb",
                                              time_it=True)
    torch.cuda.empty_cache()
    worst = {k: max(r["abs_err"] for r in v.values()) for k, v in rows.items()}
    return rows, worst


# The bf16 variant against its bf16 plain version, of max|K|: both round at
# the same points (measured: 0 at 8 x 8 and 16 x 16, 9e-6 at the head shape),
# and the fp32 kernel is 2e-3 - 6e-3 from the bf16 plain version, so a bf16
# request that ran the fp32 kernel fails by 20x or more.
K7_BF16_TOL = 1e-4
# The variant's distance from the fp32 kernel lies within [0.5x, 2x] the bf16
# plain version's (the upper side floored at 1e-3 of max|K|).
K7_BF16_FLOOR = 1e-3
K7_BF16_PIPELINE = ["--image-size", "32", "--depth", "5", "--n-train", "512", "--n-test",
                    "128", "--fused", "on", "--bf16", "--t-jitter", "1e-2"]


def k7_bf16_ops(n1, n2, h, c, depth, act, same):
    """(fp32, fp64, bf16) operations of the function K7's bf16 variant
    computes (JAX's bf16 recursion), counted as k7_ops does but by type and
    without the conversions the kernel chose: the moment (fp32, then cast),
    the pools (fp32) and, per entry and conv, the dual activation's divide,
    sqrtf and acosf / asinf (no bf16 form: 4 for relu, 3 for erf) at the
    fp32 rate; the rest of each conv (the stencil's 4 adds and / 9, w2 *,
    + b2 and the activation's other arithmetic) in bf16; the GAP's fp64
    adds."""
    from snngp_torch.ops.myrtle_gram import MYRTLE_GROUPS

    g0, g1, g2 = MYRTLE_GROUPS[depth]
    act_ops = _dual_act_ops(act, False)
    wide = 4 if act == "relu" else 3
    e1, e2, e3 = h ** 4, (h // 2) ** 4, (h // 4) ** 4
    convs = g0 * e1 + g1 * e2 + g2 * e3
    pairs = _pairs(n1, n2, same)
    fp32 = e1 * (2 * c + 1) + 2 * (e1 + e2) + wide * convs
    bf16 = (7 + act_ops - wide) * convs
    return pairs * fp32, pairs * e3, pairs * bf16


def _k7_bf16_cases():
    """(label, n1, n2, h, same, depth, act): Myrtle-5 (rectangular) and
    Myrtle-7 (symmetric, ragged: an odd image count), relu and erf, at
    8 x 8 and 16 x 16."""
    cases = []
    for h, rect, sym in ((8, (3, 4), 5), (16, (2, 3), 3)):
        for depth in (5, 7):
            for act in ("relu", "erf"):
                same = depth == 7
                n1, n2 = (sym, sym) if same else rect
                cases.append((f"{n1}x{n2} {h}x{h}x3 myrtle-{depth}" + (" sym" if same else ""),
                              n1, n2, h, same, depth, act))
    return cases


def _k7_bf16_check(label, x1, x2, depth, act, time_it=False):
    """K7's bf16 variant on one case. Gates: within K7_BF16_TOL of max|K|
    of its bf16 plain version on the card; its distance from the fp32
    kernel within [0.5x, 2x] the plain bf16 version's (the upper side
    floored at K7_BF16_FLOOR); finite;
    two launches the same bits; a symmetric launch bitwise symmetric. With
    ``time_it`` it times the bf16 and the fp32 kernel in turns (fp32, bf16,
    bf16, fp32) and the bf16 plain version once, beside the bound."""
    import torch
    from snngp_torch.ops import myrtle_gram as MG

    same = x2 is x1
    args = _myrtle_args(x1, x2, depth, act, False)
    kw = dict(depth=depth, act=act, same=same)

    def kernel(state):
        return MG.myrtle_gram_cuda(*args, **kw, state=state)

    got = kernel(torch.bfloat16)
    again = kernel(torch.bfloat16)
    f32 = kernel(None)
    times = {"fp32": [], "bf16": []}
    if time_it:
        for name in ("fp32", "bf16", "bf16", "fp32"):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            kernel(torch.bfloat16 if name == "bf16" else None)
            stop.record()
            stop.synchronize()
            times[name].append(start.elapsed_time(stop))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    plain = MG.myrtle_gram_plain(*args, depth=depth, act=act, state=torch.bfloat16)
    events[1].record()
    _sync()
    scale = f32.abs().max().item()
    vs_plain = (got - plain).abs().max().item() / scale
    d_kernel = (got - f32).abs().max().item() / scale
    d_plain = (plain - f32).abs().max().item() / scale
    finite = bool(torch.isfinite(got).all())
    repeat = torch.equal(got, again)
    sym = (got - got.T).abs().max().item() if same else float("nan")
    row = dict(rel_err=vs_plain, abs_err=(got - plain).abs().max().item(),
               vs_fp32=d_kernel, plain_vs_fp32=d_plain)
    timing = ""
    if time_it:
        row["ms"] = sum(times["bf16"]) / 2
        row["fp32_ms"] = sum(times["fp32"]) / 2
        row["plain_ms"] = events[0].elapsed_time(events[1])
        n1, n2, h, c = x1.shape[0], x2.shape[0], x1.shape[1], x1.shape[3]
        nbytes = _read_bytes(args) + 4 * got.numel()
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, *k7_bf16_ops(n1, n2, h, c, depth, act, same))
        timing = (f"  bf16 kernel {row['ms']:.3f} ms ({times['bf16'][0]:.3f}, "
                  f"{times['bf16'][1]:.3f})  fp32 kernel {row['fp32_ms']:.3f} ms "
                  f"({times['fp32'][0]:.3f}, {times['fp32'][1]:.3f})  bf16 plain "
                  f"{row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.2f}% of the "
                  f"bf16 kernel's time)")
    print(f"[K7 bf16] {act:4s} {label:28s} vs bf16 plain {vs_plain:.2e}  vs fp32 kernel: "
          f"kernel {d_kernel:.2e}, plain {d_plain:.2e}{timing}  repeat {repeat}  "
          f"max|K-K^T| {sym:.3e}")
    low, high = 0.5 * d_plain, 2.0 * max(d_plain, K7_BF16_FLOOR)
    if not (finite and vs_plain <= K7_BF16_TOL and low <= d_kernel <= high and repeat
            and (not same or sym == 0.0)):
        raise AssertionError(f"K7 bf16 {act} {label}: vs plain {vs_plain} (tol "
                             f"{K7_BF16_TOL}), vs fp32 {d_kernel} (within [{low}, {high}]), "
                             f"finite {finite}, repeat {repeat}, max|K-K^T| {sym}")
    return row


def phase14_k7_bf16():
    """K7's bf16 variant against its bf16 plain version and the fp32 kernel
    (_k7_bf16_cases, then the head shape of phase 14: 200 x 200 pairs of
    32 x 32 x 3, Myrtle-5, relu, symmetric), with the bf16 and fp32
    kernels timed in turns there. Returns (rows, worst abs error)."""
    import torch

    rng = np.random.RandomState(141)
    rows = {}
    with torch.inference_mode():
        for label, n1, n2, h, same, depth, act in _k7_bf16_cases():
            x1, x2 = _conv_inputs(rng, n1, n2, h, h, 3, same)
            rows[f"{act}/{label}"] = _k7_bf16_check(label, x1, x2, depth, act)
        x = torch.as_tensor(rng.randn(SVSP_NI, 32, 32, 3).astype(np.float32), device="cuda")
        rows[K7_HEAD] = _k7_bf16_check(K7_HEAD[5:], x, x, 5, "relu", time_it=True)
    torch.cuda.empty_cache()
    return rows, max(r["abs_err"] for r in rows.values())


def phase17_bf16_pipeline():
    """``cifar_myrtle --fused on --bf16 --t-jitter 1e-2`` at phase 17's sizes
    (no ML-II): the three Grams by K7's bf16 variant only (gate: 3 bf16
    launches and no fp32 K7 launch), bf16 in effect, a finite NLL."""
    from snngp_torch.examples import cifar_myrtle

    before = _launches()
    t0 = time.perf_counter()
    result = cifar_myrtle.main(["--device", "cuda", *K7_BF16_PIPELINE])
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _launches().items()}
    print(f"[pipeline bf16] {wall:.2f} s; phases " + "  ".join(
        f"{k} {v:.3f} s" for k, v in result["phases_s"].items())
        + f"; NLL {result['nll']:.5f}; launches {launched}")
    if not (math.isfinite(result["nll"]) and result["bf16_effective"]):
        raise AssertionError(f"bf16 pipeline: NLL {result['nll']}, bf16 in effect "
                             f"{result['bf16_effective']}")
    if launched["myrtle_bf16"] != 3 or any(v for k, v in launched.items()
                                           if k != "myrtle_bf16"):
        raise AssertionError(f"the bf16 pipeline launched {launched}; expected 3 K7 bf16")
    return dict(result, wall_s=wall, launched=launched)


def phase15_myrtle_gradient():
    """Phase 15's comparison, run before its launch window: the Myrtle svgp
    ELBO's gradient (the kernel path svtp shares) against float64 through
    K7's plain versions, at a reduced pair count: MYRTLE_CHECK_NI inducing
    images, batch MYRTLE_CHECK_NB."""
    from snngp_torch.cli.classification import _inducing_init

    x, y, _, num_class = _svsp_data()
    z_small, _ = _inducing_init(x, y, num_class, MYRTLE_CHECK_NI)
    return _svsp_gradient_check("svgp", x, y, z_small, num_class, network="myrtle",
                                nb=MYRTLE_CHECK_NB)


def phase15_myrtle_svsp():
    """Myrtle SVSP at full width on the card: synthetic32 (32 x 32 x 3), 200
    inducing images (frozen, as ``cls tr -n myrtle`` freezes them), batches
    of 100, Myrtle-5 relu: MYRTLE_STEPS timed steps each of svgp and svtp
    (after one untimed step), split by phase, with the peak memory. A step
    launches 3 K7 (the three Gram blocks) and 3 K7 tangent passes (their
    scale cotangents)."""
    x, y, z, num_class = _svsp_data()
    want = {"myrtle": 3, "myrtle_grads": 3}
    return {f"myrtle {m}": _svsp_steps(f"myrtle {m}", m, x, y, z, num_class, want,
                                       trainable_inputs=False, network="myrtle",
                                       steps=MYRTLE_STEPS)
            for m in ("svgp", "svtp")}


def phase16_myrtle_cli():
    """``cls tr -n myrtle -nh 5 -m svtp -dn synthetic32 -e 1`` on the card
    (MYRTLE_CLI sizes), then ``cls ts`` on the card and on the CPU (K7's
    plain version; gate: within the Monte Carlo tolerance) and ``cls pr``."""
    work = REPO / "build" / "chip_smoke" / "cls_myrtle"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    _run_cli(["--device", "cuda", "cls", "tr", "-m", "svtp", "-n", "myrtle", "-dn",
              "synthetic32", "-e", "1", *MYRTLE_CLI, "-nh", str(MYRTLE_DEPTH), "-cr",
              str(work), "-cn", "cuda", "-q"])
    times = {"tr": time.perf_counter() - t0}
    ckpt = work / "cuda"
    text = (ckpt / "train.log").read_text()
    if "Traceback" in text or "inducing inputs fixed" not in text:
        raise AssertionError(text)
    lines = [ln for ln in text.splitlines() if ln.startswith("[") and "NLL:" in ln]
    print(f"[cls-myrtle] cls tr: {times['tr']:.2f} s; " + " | ".join(lines[-3:]))
    test = ["-dn", "synthetic32", "-cd", str(ckpt), "-nd", str(MYRTLE_TEST_N), "-nb",
            str(MYRTLE_TEST_N), "-q"]
    nll = {}
    for device in ("cuda", "cpu"):
        shutil.rmtree(ckpt / "test", ignore_errors=True)
        t0 = time.perf_counter()
        _run_cli(["--device", device, "cls", "ts", *test])
        nll[device] = _cls_nll(ckpt / "test")
        times[f"ts {device}"] = time.perf_counter() - t0
    _run_cli(["--device", "cuda", "cls", "pr", *test])
    nll["pr"] = _nll(ckpt / "predict" / "predict.log")
    tol = _mc_tolerance(ckpt, MYRTLE_TEST_N, 10_000)
    print(f"[cls-myrtle] cls ts NLL cuda {nll['cuda']:.5f} ({times['ts cuda']:.2f} s) cpu "
          f"{nll['cpu']:.5f} ({times['ts cpu']:.2f} s), |diff| "
          f"{abs(nll['cuda'] - nll['cpu']):.2e} (MC tolerance {tol:.2e}); cls pr NLL "
          f"{nll['pr']:.5f}")
    if not all(math.isfinite(v) for v in nll.values()):
        raise AssertionError(f"non-finite NLL {nll}")
    if not abs(nll["cuda"] - nll["cpu"]) <= tol:
        raise AssertionError(f"myrtle cls ts: CUDA and CPU NLLs differ beyond MC error "
                             f"({tol:.2e})")
    np.testing.assert_allclose(nll["pr"], nll["cuda"], rtol=1e-4)
    return dict(nll=nll, tol=tol, times=times)


def phase17_pipeline():
    """The north-star pipeline, ``python -m snngp_torch.examples.cifar_myrtle
    --device cuda`` with PIPELINE's arguments on the seeded synthetic images
    (CIFAR-10 is not in the repository): its per-phase report and a finite
    NLL, launching only K7 (and its tangent mode, in the ML-II fit)."""
    from snngp_torch.examples import cifar_myrtle

    before = _launches()
    t0 = time.perf_counter()
    result = cifar_myrtle.main(["--device", "cuda", *PIPELINE])
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _launches().items()}
    print(f"[pipeline] {wall:.2f} s; phases " + "  ".join(
        f"{k} {v:.3f} s" for k, v in result["phases_s"].items())
        + f"; NLL {result['nll']:.5f}; launches {launched}")
    if not math.isfinite(result["nll"]):
        raise AssertionError(f"pipeline NLL {result['nll']}")
    if any(v for k, v in launched.items() if k not in ("myrtle", "myrtle_grads")) \
            or not launched["myrtle"]:
        raise AssertionError(f"the pipeline launched {launched}; expected K7 only")
    return dict(result, wall_s=wall, launched=launched)


def phase17_full_tier(hyper):
    """Phase 17's comparison, run after its launch window: K7 against the
    full tier on a 64-image block of the pipeline's images, at the
    hyperparameters its ML-II fit found."""
    import torch
    from snngp_torch.examples import cifar_myrtle
    from snngp_torch.nn.full import get_myrtle_kernel, scan_tiled_gram
    from snngp_torch.ops import myrtle_gram as MG

    x, _ = cifar_myrtle.load_images(64, 32, seed=0)
    x = torch.as_tensor(x, device="cuda")
    with torch.inference_mode():
        k7 = MG.myrtle_gram(x, depth=MYRTLE_DEPTH, **hyper)
        full = scan_tiled_gram(get_myrtle_kernel(MYRTLE_DEPTH, 1, "relu", **hyper), x,
                               tile=16)
    rel = float(np.abs(k7.cpu().numpy() - full).max() / np.abs(full).max())
    print(f"[pipeline] K7 against the full tier on 64 x 64 pairs: rel err {rel:.3e}")
    if not rel <= 2e-5:    # two summation orders (tests/test_myrtle_pallas.py's bar)
        raise AssertionError(f"K7 against the full tier: rel err {rel:.3e}")
    torch.cuda.empty_cache()
    return rel


def _mlii_images(kind):
    """MLII_N seeded 32 x 32 x 3 images and standardized targets: "normal"
    (standard-normal images and targets) or "uniform" (the pipeline's own
    synthetic set, images uniform on [0, 1) and standardized labels, which
    ``--mlii-scope full`` trains on)."""
    if kind == "normal":
        rng = np.random.RandomState(21)
        return (rng.randn(MLII_N, 32, 32, 3).astype(np.float32),
                rng.randn(MLII_N).astype(np.float32))
    from snngp_torch.examples import cifar_myrtle

    x, y = cifar_myrtle.load_images(MLII_N, 32, seed=0)
    return x, ((y - y.mean()) / y.std()).astype(np.float32)


def _closed_form_f64(k, dkw, dkb, y, eps, ab, last_w_std):
    """The closed-form loss and constrained gradients over {w_std, b_std,
    last_w_std, eps} in float64 (numpy) on the given tiles, and the
    condition number of S = K + eps I."""
    from snngp_torch.models.mlii import gram_cotangent_coeffs

    k, dkw, dkb = (np.asarray(a, np.float64) for a in (k, dkw, dkb))
    y = np.asarray(y, np.float64)
    n = k.shape[0]
    s = k + eps * np.eye(n)
    s_inv = np.linalg.inv(s)
    alpha = s_inv @ y
    q = float(y @ alpha)
    c_inv, c_aa = gram_cotangent_coeffs(q, n, ab=ab)
    dks = {"w_std": dkw, "b_std": dkb, "last_w_std": (2.0 / last_w_std) * k,
           "eps": np.eye(n)}
    grads = {name: c_inv * np.sum(s_inv * dk) + c_aa * float(alpha @ dk @ alpha)
             for name, dk in dks.items()}
    logdet = np.linalg.slogdet(s)[1]
    if ab is None:
        loss = (q + logdet + n * math.log(2 * math.pi)) / (2 * n)
    else:
        a, b = ab
        df, half = 2 * a, a + n / 2
        loss = (half * math.log1p((a / b) * q / df) + 0.5 * n * math.log(df * math.pi)
                - math.lgamma(half) + math.lgamma(a) + 0.5 * (n * math.log(b / a) + logdet)) / n
    return loss, grads, float(np.linalg.cond(s))


def _mlii_autograd(x_np, y_np, ab, dtype):
    """SPR.loss and its raw-parameter gradients by autograd on the card:
    float32 through ``get_myrtle_kernel(trainable_inputs=False)`` (K7 and
    its tangent mode), float64 through K7's plain versions."""
    import torch
    from snngp_torch.models import SPR, GaussianLikelihood, NNGPKernel, StudentTLikelihood
    from snngp_torch.nn.arch import get_myrtle_kernel
    from snngp_torch.ops import myrtle_gram as MG

    def builder(w, b, last):
        if dtype == torch.float32:
            return get_myrtle_kernel(MYRTLE_DEPTH, 1, "relu", w_std=w, b_std=b,
                                     last_w_std=last, trainable_inputs=False)

        def kernel_fn(x1, x2=None, get="nngp"):
            x2e = x1 if x2 is None else x2
            return MG._MyrtleGram.apply(x1, x2e, w, b, last, MYRTLE_DEPTH, "relu", False,
                                        x2e is x1, True)
        return kernel_fn

    lik = GaussianLikelihood() if ab is None else StudentTLikelihood(*ab)
    model = SPR(NNGPKernel(builder, **MLII_HYPER), lik, x_np, y_np, 0.0, 1.0,
                eps=MLII_EPS).to(device="cuda", dtype=dtype)
    if dtype == torch.float64:
        # the raw parameters were rounded to fp32 at construction: set them
        # again in float64, so the witness sits at the exact values
        values = dict(MLII_HYPER, eps=MLII_EPS, **dict(zip("ab", ab or ())))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(model.bij.inverse(torch.tensor(
                    values[name.rpartition(".")[2]], dtype=torch.float64)))
    # SPR.loss adds eps to the diagonal: the absolute eps of the closed form.
    with torch.enable_grad():
        loss = model.loss()
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    # raw -> constrained through the softplus bijector: dt/du = sigmoid(u)
    chain = {n.rpartition(".")[2]: torch.sigmoid(p.detach()).item() for n, p in named}
    out = {n.rpartition(".")[2]: g.item() for (n, _), g in zip(named, grads)}
    return loss.item(), out, chain


def _mlii_routes(kind, witness):
    """Full-Gram ML-II's loss and raw gradients on MLII_N ``kind`` images,
    for gp and tp, by the routes: "closed form" (``tiled_aug_gram`` of K7's
    tangent-mode tiles, then ``full_gram_mlii_value_and_grad``), "autograd"
    (SPR.loss through K7, fp32) and "f64 on fp32 tiles" (the closed form in
    numpy float64 on the same tiles); with ``witness`` also the float64
    witnesses "f64 closed form" (on K7's plain float64 tangent tiles) and
    "f64 autograd" (through K7's plain versions in float64)."""
    import torch
    from snngp_torch.models.mlii import full_gram_mlii_value_and_grad, tiled_aug_gram
    from snngp_torch.ops import myrtle_gram as MG

    x_np, y_np = _mlii_images(kind)
    x = torch.as_tensor(x_np, device="cuda")
    h = MLII_HYPER
    aug = functools.partial(MG.myrtle_gram_scale_grads, depth=MYRTLE_DEPTH, act="relu", **h)
    prof = functools.partial(MG.myrtle_profile_tangents, depth=MYRTLE_DEPTH, act="relu",
                             w_std=h["w_std"], b_std=h["b_std"])
    before = MG.LAUNCHES["myrtle_grads"]
    (k, dkw, dkb), t_asm = _timed(lambda: tiled_aug_gram(aug, x, block=MLII_BLOCK,
                                                         profile_fn=prof))
    tiles = MG.LAUNCHES["myrtle_grads"] - before
    print(f"[mlii] {kind}: tiled_aug_gram of {MLII_N} 32x32x3 images, block {MLII_BLOCK}: "
          f"{tiles} tangent-mode launches, {t_asm:.3f} s")
    if tiles != 6:
        raise AssertionError(f"{tiles} tangent-mode launches for 6 tiles")
    if witness:
        x64 = x.double()
        scales = [torch.tensor(h[n], dtype=torch.float64, device="cuda")
                  for n in ("w_std", "b_std", "last_w_std")]
        (k64, dkw64, dkb64), t64 = _timed(lambda: [
            t.cpu().numpy() for t in MG._tangents(x64, x64, *scales, MYRTLE_DEPTH, "relu",
                                                  plain=True)])
        print(f"[mlii] {kind}: float64 tangent tiles through K7's plain version, {t64:.1f} "
              f"s; max |K fp32 - K fp64| / max |K| "
              f"{np.abs(k - k64).max() / np.abs(k64).max():.2e}")

    # each closed form to raw space through its precision's bijector
    def raw(g, chain):
        return {n: g[n] * chain[n] for n in g}

    routes = {}
    for method, ab in (("gp", None), ("tp", MLII_AB)):
        (loss, g_c), t_closed = _timed(lambda: full_gram_mlii_value_and_grad(
            k, dkw, dkb, y_np, last_w_std=h["last_w_std"], eps=MLII_EPS, ab=ab,
            panel=MLII_BLOCK, device="cuda"))
        loss32, g32, chain32 = _mlii_autograd(x_np, y_np, ab, torch.float32)
        lt, gt, cond = _closed_form_f64(k, dkw, dkb, y_np, MLII_EPS, ab, h["last_w_std"])
        r = routes[method] = {"closed form": (loss, raw(g_c, chain32)),
                              "autograd": (loss32, g32),
                              "f64 on fp32 tiles": (lt, raw(gt, chain32))}
        timing = f"closed form {t_closed:.3f} s"
        if witness:
            (loss64, g64, chain64), t_ag64 = _timed(lambda: _mlii_autograd(
                x_np, y_np, ab, torch.float64))
            lcf64, gcf64, _ = _closed_form_f64(k64, dkw64, dkb64, y_np, MLII_EPS, ab,
                                               h["last_w_std"])
            r["f64 closed form"] = (lcf64, raw(gcf64, chain64))
            r["f64 autograd"] = (loss64, g64)
            timing += f", float64 autograd {t_ag64:.1f} s"
        print(f"[mlii] {kind} {method}: cond(S) {cond:.3e}; {timing}")
        for route, (lv, g) in r.items():
            print(f"[mlii] {kind} {method} {route:17s} loss {lv:.9f} " + " ".join(
                f"d/d{n} {g[n]:.7e}" for n in sorted(g)))
    return routes


def _mlii_gate(kind, routes, got, want, rtol_loss, rtol, atol):
    """Hold route ``got`` to route ``want`` on the loss and on every
    gradient both have, for gp and tp; prints the relative gaps."""
    for method, r in routes.items():
        (loss, g), (ref, g_ref) = r[got], r[want]
        g_ref = {n: v for n, v in g_ref.items() if n in g}
        rel = {n: abs(g[n] - v) / abs(v) for n, v in g_ref.items()}
        print(f"[mlii] {kind} {method} {got} against {want}: loss rel "
              f"{abs(loss - ref) / abs(ref):.2e}; " + " ".join(
                  f"d/d{n} {v:.2e}" for n, v in sorted(rel.items())))
        if not abs(loss - ref) <= rtol_loss * abs(ref):
            raise AssertionError(f"{kind} {method} loss: {got} {loss:.9f}, {want} {ref:.9f}")
        for name, v in g_ref.items():
            if not abs(g[name] - v) <= atol + rtol * abs(v):
                raise AssertionError(f"{kind} {method} d/d{name}: {got} {g[name]:.7e}, "
                                     f"{want} {v:.7e}")


def _mlii_memory():
    """Peak device memory of one ``full_gram_mlii_value_and_grad`` at N =
    MLII_MEM_N over S's own bytes (the factorization runs in S's storage;
    gate: below 1.5 N^2 fp32)."""
    import torch
    from snngp_torch.models.mlii import full_gram_mlii_value_and_grad

    n = MLII_MEM_N
    rng = np.random.RandomState(22)
    f = rng.randn(n, 64).astype(np.float32)
    k = f @ f.T / 64.0 + np.eye(n, dtype=np.float32)
    y = rng.randn(n).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss, _ = full_gram_mlii_value_and_grad(k, k, k, y, last_w_std=1.0, eps=1e-2,
                                            panel=MLII_MEM_PANEL, device="cuda")
    peak = torch.cuda.max_memory_allocated() - base
    s_bytes = 4 * n * n
    print(f"[mlii] value_and_grad at N={n}, panel {MLII_MEM_PANEL}: peak device memory "
          f"{peak / 2**20:.1f} MiB = {peak / s_bytes:.3f} x S's {s_bytes / 2**20:.1f} MiB; "
          f"loss {loss:.6f}")
    if not (math.isfinite(loss) and peak <= 1.5 * s_bytes):
        raise AssertionError(f"peak {peak} bytes for an S of {s_bytes} bytes (loss {loss})")
    return peak / s_bytes


def phase21_mlii():
    """Full-Gram ML-II on the card, on its main path: ``cifar_myrtle --mlii 2
    --mlii-scope full`` at N = 256 (K7's tangent mode in every tile of each
    step's assembly, K7 in the Grams that follow; gate: a finite NLL)."""
    import tempfile

    import torch
    from snngp_torch.examples import cifar_myrtle

    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        result, wall = _timed(lambda: cifar_myrtle.main(["--device", "cuda", *MLII_PIPELINE,
                                                         "--resume-gram", tmp]))
    steps = int(MLII_PIPELINE[MLII_PIPELINE.index("--mlii") + 1])
    print(f"[mlii] cifar_myrtle --mlii-scope full, N=256: {wall:.2f} s, ML-II "
          f"{result['mlii_s']:.2f} s ({result['mlii_s'] / steps:.2f} s a step), NLL "
          f"{result['nll']:.5f}, hyper {result['hyper']}")
    if not math.isfinite(result["nll"]):
        raise AssertionError(f"full-scope pipeline NLL {result['nll']}")
    torch.cuda.empty_cache()
    return dict(step_s=result["mlii_s"] / steps)


def phase21_mlii_gradient():
    """Phase 21's comparison, run after the Myrtle launch window: the
    closed-form loss and gradients (``full_gram_mlii_value_and_grad`` on
    ``tiled_aug_gram``, K7's tangent mode with a symmetric launch on each
    diagonal tile) against autograd of SPR.loss through
    ``get_myrtle_kernel(trainable_inputs=False)`` on MLII_N seeded
    standard-normal images, gp and tp (gate: loss rtol 1e-5, gradients rtol
    2e-3, atol 1e-6); on both image sets, the closed form against float64
    arithmetic on its own fp32 tiles (the same gate); on the pipeline's
    uniform images, the float64 closed form against float64 autograd
    (gate: rtol 1e-6, atol 1e-12); the factorization's peak memory."""
    import torch

    normal = _mlii_routes("normal", witness=False)
    _mlii_gate("normal", normal, "closed form", "autograd", 1e-5, 2e-3, 1e-6)
    _mlii_gate("normal", normal, "closed form", "f64 on fp32 tiles", 1e-5, 2e-3, 1e-6)
    uniform = _mlii_routes("uniform", witness=True)
    _mlii_gate("uniform", uniform, "f64 closed form", "f64 autograd", 1e-6, 1e-6, 1e-12)
    _mlii_gate("uniform", uniform, "closed form", "f64 on fp32 tiles", 1e-5, 2e-3, 1e-6)
    for route in ("closed form", "autograd"):   # the reading: each fp32 route's error
        for method, r in uniform.items():
            (_, g), (_, g64) = r[route], r["f64 autograd"]
            print(f"[mlii] uniform {method} {route} against f64 autograd: " + " ".join(
                f"d/d{n} {abs(g[n] - v) / abs(v):.2e}" for n, v in sorted(g64.items())))
    mem = _mlii_memory()
    torch.cuda.empty_cache()
    return dict(normal=normal, uniform=uniform, mem=mem)


# -- memory-lean fit and the mesh (exact-GP regression) ---------------------------------

def _peak_since(base):
    import torch
    return torch.cuda.max_memory_allocated() - base


def _reset_peak():
    """Empty the cache, reset the peak; returns the bytes allocated now."""
    import torch
    _sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _lean_data():
    """Phase 2's data recipe at LEAN_N points: x [N, 16] standard normal,
    standardized targets, one REQUEST_SIZE-point request."""
    rng = np.random.RandomState(24)
    x = rng.randn(LEAN_N, SERVE_D).astype(np.float32)
    u = rng.randn(SERVE_D) / math.sqrt(SERVE_D)
    y = np.sin(2.0 * x @ u) + 0.5 * np.cos(x[:, 0]) + 0.1 * rng.randn(LEAN_N)
    x_req = rng.randn(REQUEST_SIZE, SERVE_D).astype(np.float32)
    y_mean, y_std = y.mean(), y.std()
    return x, ((y - y_mean) / y_std).astype(np.float32), x_req, y_mean, y_std


def phase24_k1_rows(lean):
    """Phase 24's comparison, run before its launch window: K1's symmetric
    launch at N = LEAN_N (1.2e10 outputs, past 2^31) against its plain
    version on LEAN_ROWS sampled rows (the first and last among them);
    gate: KERNEL_REL_TOL of max |K| on those rows."""
    import torch
    from snngp_torch.ops import gram as G

    x, y, _, y_mean, y_std = lean
    model = _model(x, y, y_mean, y_std, fused=True, dtype=torch.float32)
    (gram, t) = _timed(lambda: model._gram(model.kernel.get_kernel_fn()))
    rows = np.unique(np.r_[0, LEAN_N - 1, np.random.RandomState(240).choice(
        LEAN_N, LEAN_ROWS - 2, replace=False)])
    idx = torch.as_tensor(rows, device="cuda")
    got = gram[idx].double()
    del gram
    torch.cuda.empty_cache()       # no later allocation may split the freed 45 GiB
    w, b, last = (v.detach() for v in model.kernel.get_params())
    xd = model.x_data
    vs = G.mlp_var_stack(xd, DEPTH, "relu", w, b)
    scales = torch.stack([w * w, b * b, last * last,
                          torch.tensor(1.0 / SERVE_D, device="cuda")])
    want = G.gram_plain(xd[idx], xd, vs[:, idx], vs, scales, depth=DEPTH, act="relu",
                        mode="mlp").double()
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[lean] K1 at N={LEAN_N} (symmetric launch, {LEAN_N ** 2:.3e} outputs): "
          f"{t:.3f} s; {len(rows)} rows against the plain version: rel err {err:.3e}")
    if not err <= KERNEL_REL_TOL:
        raise AssertionError(f"K1 rows at N={LEAN_N}: error {err:.3e}")
    del model
    torch.cuda.empty_cache()
    return dict(gram_s=t, rows_err=err)


def _requests(fitted, x_req):
    import torch
    xs = torch.as_tensor(x_req, device="cuda")
    out = [fitted.predict(xs[i * REQUEST_SIZE:(i + 1) * REQUEST_SIZE], batch=PREDICT_BATCH)
           for i in range(REQUESTS)]
    return torch.cat([m for m, _ in out]), torch.cat([v for _, v in out])


def _backward_error(model, fitted):
    """max |(K + reg I) alpha - y| / (max row sum |K + reg I| max |alpha| +
    max |y|), in float64, with K recomputed in LEAN_PANEL-row panels by K1
    (x's rows against all of x); reg is the fit's eps mean(diag K)."""
    import torch
    from snngp_torch.models import params as P

    x, y = model.x_data, model.y_data.double()
    alpha = fitted.state["alpha"][:, 0].double()
    kfn = model.kernel.get_kernel_fn()
    kalpha = torch.empty_like(alpha)
    rowsum = torch.empty_like(alpha)
    trace = 0.0
    for r0 in range(0, x.shape[0], LEAN_PANEL):
        panel = model.kernel.K(kfn, x[r0:r0 + LEAN_PANEL], x).double()
        kalpha[r0:r0 + panel.shape[0]] = panel @ alpha
        rowsum[r0:r0 + panel.shape[0]] = panel.abs().sum(1)
        trace += panel.diagonal(offset=r0).sum().item()
        del panel
    reg = P.constrained_read(model.eps, model.bij).item() * trace / x.shape[0]
    resid = (kalpha + reg * alpha - y).abs().max().item()
    scale = (rowsum + reg).max().item() * alpha.abs().max().item() + y.abs().max().item()
    return resid / scale


def phase24_lean(data, ref64, default_errs, lean):
    """The memory-lean fit: at phase 2's N against phase 2's float64
    requests (gate: mean and variance errors within 2x the default fp32
    fit's); at N = LEAN_N its peak device memory (gate: <= LEAN_PEAK x 4
    N^2 bytes), its backward error (gate: <= LEAN_BACKWARD), one request
    from the upper factor (gate: finite, positive variances; peak above the
    factor <= 10% of its bytes); the Weinstein-Aronszajn witness of
    ``inplace_blocked_cholesky`` at N = LEAN_N (gate: logdet rtol WA_RTOL)."""
    import torch
    from snngp_torch.models import fit_spr
    from snngp_torch.parallel.cholesky import inplace_blocked_cholesky

    x, y, x_req, y_mean, y_std = data
    model = _model(x, y, y_mean, y_std, fused=True, dtype=torch.float32)
    fitted, t_fit = _timed(lambda: fit_spr(model, memory_lean=True, t_jitter=SERVE_T_JITTER))
    mean, var = _requests(fitted, x_req)
    mean64, var64 = ref64

    def err(a, ref_):
        return ((a.double() - ref_).abs().max() / ref_.abs().max()).item()

    errs = (err(mean, mean64), err(var, var64))
    print(f"[lean] N={SERVE_N}: fit {t_fit:.4f} s; against phase 2's float64: mean rel err "
          f"{errs[0]:.3e} (default fp32 fit {default_errs[0]:.3e}), var rel err "
          f"{errs[1]:.3e} (default {default_errs[1]:.3e})")
    for i, what in enumerate(("mean", "var")):
        if not errs[i] <= 2.0 * max(default_errs[i], 1e-6):
            raise AssertionError(f"lean {what} error {errs[i]:.3e} above 2x the default "
                                 f"fit's {default_errs[i]:.3e}")
    del model, fitted, mean, var

    xl, yl, xl_req, yl_mean, yl_std = lean
    n = LEAN_N
    model = _model(xl, yl, yl_mean, yl_std, fused=True, dtype=torch.float32)
    base = _reset_peak()
    fitted, t_fit = _timed(lambda: fit_spr(model, memory_lean=True, t_jitter=SERVE_T_JITTER))
    peak = _peak_since(base)
    nbytes = 4 * n * n
    u = fitted.state["chol"]
    finite = bool(torch.isfinite(torch.diagonal(u)).all()) and math.isfinite(
        fitted.state["d"].item())
    print(f"[lean] N={n} D={SERVE_D} depth {DEPTH} relu, Student-t: fit_spr(memory_lean=True) "
          f"{t_fit:.2f} s (two K1 Grams, two in-place factorizations, three panel solves); "
          f"peak {peak / 2**30:.2f} GiB = {peak / nbytes:.4f} x 4N^2 ({nbytes / 2**30:.2f} GiB)"
          f"; d {fitted.state['d'].item():.4f}; finite {finite}")
    if not (finite and peak <= LEAN_PEAK * nbytes):
        raise AssertionError(f"lean fit at N={n}: peak {peak} bytes, finite {finite}")
    eta, t_res = _timed(lambda: _backward_error(model, fitted))
    print(f"[lean] backward error of alpha (float64 residual, K1 row panels of {LEAN_PANEL}): "
          f"{eta:.3e} ({t_res:.2f} s)")
    if not eta <= LEAN_BACKWARD:
        raise AssertionError(f"backward error {eta:.3e} > {LEAN_BACKWARD}")
    base = _reset_peak()
    (mean, var), t_req = _timed(lambda: fitted.predict(
        torch.as_tensor(xl_req, device="cuda"), batch=PREDICT_BATCH))
    (mean, var), t_req2 = _timed(lambda: fitted.predict(
        torch.as_tensor(xl_req, device="cuda"), batch=PREDICT_BATCH))
    req_peak = _peak_since(base)
    ok = bool(torch.isfinite(mean).all() and (var > 0).all())
    print(f"[lean] one {REQUEST_SIZE}-point request from the upper factor: {t_req * 1e3:.1f} "
          f"ms, again {t_req2 * 1e3:.1f} ms; peak above the factor "
          f"{req_peak / 2**30:.3f} GiB = {req_peak / nbytes:.4f} of its bytes; finite and "
          f"positive {ok}")
    if not (ok and req_peak <= 0.10 * nbytes):
        raise AssertionError(f"request from the upper factor: peak {req_peak}, ok {ok}")
    del model, fitted, u, mean, var
    _reset_peak()

    gen = torch.Generator(device="cuda").manual_seed(241)
    xw = torch.randn((n, WA_R), generator=gen, device="cuda")
    want = torch.linalg.slogdet(torch.eye(WA_R, dtype=torch.float64, device="cuda")
                                + xw.double().T @ xw.double() / WA_R)[1].item()
    k, t_build = _timed(lambda: torch.mm(xw, xw.T).div_(WA_R))
    k.diagonal().add_(1.0)
    base = _reset_peak()
    u, t_chol = _timed(lambda: inplace_blocked_cholesky(k))
    chol_peak = _peak_since(base)
    got = (2.0 * torch.log(torch.diagonal(u).double()).sum()).item()
    rel = abs(got - want) / abs(want)
    print(f"[lean] Weinstein-Aronszajn witness, K = I + X X^T / {WA_R} at N={n}: build "
          f"{t_build:.2f} s, inplace_blocked_cholesky {t_chol:.2f} s ({n ** 3 / 3 / t_chol / 1e12:.1f}"
          f" TFLOP/s), extra peak {chol_peak / 2**20:.1f} MiB; logdet {got:.6f} against "
          f"{want:.6f}: rel {rel:.2e}")
    del k, u, xw
    torch.cuda.empty_cache()
    if not rel <= WA_RTOL:
        raise AssertionError(f"witness logdet rel error {rel:.3e} > {WA_RTOL}")
    return dict(fit_s=t_fit, peak_ratio=peak / nbytes, backward_error=eta,
                request_ms=1e3 * t_req2, request_peak=req_peak / nbytes, chol_s=t_chol,
                wa_rel=rel, small_errs=errs)


def _mesh(shape=None, shards=MESH_SHARDS):
    from snngp_torch.parallel import get_mesh
    size = shards if shape is None else int(np.prod(shape))
    return get_mesh(shape=shape, devices=["cuda:0"] * size)


def _mesh_gram_inputs():
    import torch
    from snngp_torch.nn import arch
    x = np.random.RandomState(25).randn(MESH_N, MESH_D).astype(np.float32)
    kfn = arch.get_mlp_kernel(3, act="relu", w_std=1.0, b_std=0.3, last_w_std=1.0)
    return torch.as_tensor(x, device="cuda"), kfn


def _mlii_mesh_data():
    rng = np.random.RandomState(251)
    return (rng.randn(MESH_MLII_N, 32, 32, 3).astype(np.float32),
            rng.randn(MESH_MLII_N).astype(np.float32))


def _mesh_aug():
    from snngp_torch.ops import myrtle_gram as MG
    return functools.partial(MG.myrtle_gram_scale_grads, depth=MYRTLE_DEPTH, act="relu",
                             **MLII_HYPER)


def _backward_err(lfac, s, rows=4096):
    """max|L L^T - S| / max|S| of a lower factor, in float64 by row panels
    over the lower triangle (S symmetric)."""
    import torch
    l64 = lfac.double()
    worst = 0.0
    for r0 in range(0, s.shape[0], rows):
        r1 = min(r0 + rows, s.shape[0])
        d = l64[r0:r1] @ l64[:r1].mT - s[r0:r1, :r1].double()
        worst = max(worst, d.abs().max().item())
    return worst / s.abs().max().item()


def phase25_references():
    """Phase 25's references, run before its launch window: the K1 Gram at
    MESH_N x MESH_D (a symmetric launch), cuSOLVER's factor of it plus
    MESH_EPS with its logdet and its backward error, and for full-Gram ML-II at MESH_MLII_N images (K7's tangent
    mode), gp and tp: the single-device closed form on ``tiled_aug_gram``'s
    tiles, and the float64 closed form on the row panels that
    ``sharded_aug_gram`` gives the mesh."""
    import torch
    from snngp_torch.models.mlii import full_gram_mlii_value_and_grad, tiled_aug_gram
    from snngp_torch.parallel.mesh import gather
    from snngp_torch.parallel.mlii import sharded_aug_gram

    x, kfn = _mesh_gram_inputs()
    gram, t_gram = _timed(lambda: kfn(x, x, get="nngp"))
    s = gram.clone()
    s.diagonal().add_(MESH_EPS)
    (chol, info), t_chol = _timed(lambda: torch.linalg.cholesky_ex(s))
    logdet = (2.0 * torch.log(torch.diagonal(chol).double()).sum()).item()
    backward = _backward_err(chol, s)
    del s
    xm, ym = _mlii_mesh_data()
    xm = torch.as_tensor(xm, device="cuda")
    tiles = tiled_aug_gram(_mesh_aug(), xm, block=MLII_BLOCK)
    panels = [gather(p).cpu().numpy() for p in sharded_aug_gram(_mesh_aug(), xm, _mesh())]
    last = MLII_HYPER["last_w_std"]
    mlii = {}
    for method, ab in (("gp", None), ("tp", MLII_AB)):
        single = full_gram_mlii_value_and_grad(*tiles, ym, last_w_std=last, eps=MLII_EPS,
                                               ab=ab, device="cuda")
        loss64, grads64, cond = _closed_form_f64(*panels, ym, MLII_EPS, ab, last)
        mlii[method] = dict(single=single, f64=(loss64, grads64), cond=cond)
        print(f"[mesh] reference ML-II {method}: cond(S) {cond:.3e}; single device loss "
              f"{single[0]:.7f}, float64 on the row panels {loss64:.7f}")
    print(f"[mesh] references: K1 Gram N={MESH_N} D={MESH_D} {t_gram:.3f} s, cuSOLVER "
          f"cholesky {t_chol:.3f} s (info {int(info)}), logdet {logdet:.6f}, backward "
          f"error max|L L^T - S| / max|S| {backward:.3e}")
    return dict(gram=gram, chol=chol, logdet=logdet, backward=backward, mlii=mlii)


def phase25_mesh(data, refs, train_gradients):
    """The mesh on one card: MESH_SHARDS shards of cuda:0 (and 2 x 2). Gates:
    ``sharded_gram`` (row panels; 2-D tiles) within KERNEL_REL_TOL of max|K|
    of the single-device K1 Gram; ``cyclic_cholesky`` and
    ``distributed_cholesky`` (pjit): factors within MESH_FACTOR_RTOL of
    max|L| of cuSOLVER's, backward errors within MESH_BACKWARD_X of
    cuSOLVER's own, logdets within MESH_LOGDET_RTOL of its; ``mesh_pipeline`` at N = MESH_N passes its own parity gate;
    ``SPR.loss``'s gradients on the mesh at phase 5's N within 2x the
    single-device fp32 error against float64 autograd; and
    ``distributed_mlii_value_and_grad`` at MESH_MLII_N images through K7's
    tangent mode against ``full_gram_mlii_value_and_grad`` and against the
    float64 closed form on its own row panels (loss rtol 1e-5, gradients
    rtol 2e-3, atol 1e-6). The shards run one after another: these times are
    not a multi-card time."""
    import torch
    from snngp_torch.examples import mesh_pipeline
    from snngp_torch.parallel import distributed_cholesky, distributed_mlii_value_and_grad
    from snngp_torch.parallel import sharded_gram
    from snngp_torch.parallel.cholesky import blocked_cholesky, cyclic_cholesky
    from snngp_torch.parallel.mesh import gather

    out = {}
    with torch.no_grad():
        x, kfn = _mesh_gram_inputs()
        ref = refs["gram"]
        scale = ref.abs().max()
        for label, mesh in (("1-D x4", _mesh()), ("2-D 2x2", _mesh((2, 2)))):
            got, t = _timed(lambda: gather(sharded_gram(kfn, x, mesh)))
            e = ((got - ref).abs().max() / scale).item()
            print(f"[mesh] sharded_gram {label} at N={MESH_N} D={MESH_D}: {t:.3f} s; rel err "
                  f"{e:.3e} against the single-device K1 Gram")
            if not e <= KERNEL_REL_TOL:
                raise AssertionError(f"sharded_gram {label}: error {e:.3e}")
            out[f"gram {label}"] = (t, e)
            del got
        mesh = _mesh()
        s = ref.clone()
        s.diagonal().add_(MESH_EPS)
        for label, fn in (("cyclic_cholesky", lambda: cyclic_cholesky(s, mesh,
                                                                      block=MESH_BLOCK)),
                          ("distributed_cholesky pjit", lambda: distributed_cholesky(
                              s, mesh, block=MESH_BLOCK, strategy="pjit"))):
            lfac, t = _timed(fn)
            logdet = (2.0 * torch.log(torch.diagonal(lfac).double()).sum()).item()
            rel = abs(logdet - refs["logdet"]) / abs(refs["logdet"])
            lref = refs["chol"]
            fwd = ((lfac - lref).abs().max() / lref.abs().max()).item()
            bwd = _backward_err(lfac, s)
            print(f"[mesh] {label} (block {MESH_BLOCK}) at N={MESH_N}: {t:.3f} s; logdet "
                  f"{logdet:.6f}, rel {rel:.2e} against cuSOLVER's; factor max|L - L_ref| / "
                  f"max|L_ref| {fwd:.3e}; backward error {bwd:.3e} (cuSOLVER's "
                  f"{refs['backward']:.3e})")
            if not rel <= MESH_LOGDET_RTOL:
                raise AssertionError(f"{label}: logdet rel error {rel:.3e}")
            if not fwd <= MESH_FACTOR_RTOL:
                raise AssertionError(f"{label}: factor rel error {fwd:.3e}")
            if not bwd <= MESH_BACKWARD_X * refs["backward"]:
                raise AssertionError(f"{label}: backward error {bwd:.3e} against cuSOLVER's "
                                     f"{refs['backward']:.3e}")
            out[label] = (t, rel, fwd, bwd)
            del lfac
        del s, ref
        refs.pop("gram")
        refs.pop("chol")
        torch.cuda.empty_cache()

    result = mesh_pipeline.main(MESH_PIPELINE, mesh=mesh)
    print(f"[mesh] mesh_pipeline N={MESH_N}: NLL {result['nll']:.6f} (one device "
          f"{result['parity_nll']:.6f}); phases " + ", ".join(
              f"{k} {v:.3f} s" for k, v in result["phases_s"].items()))
    out["pipeline"] = result
    torch.cuda.empty_cache()

    xs, ys, _, y_mean, y_std = data
    model = _model(xs, ys, y_mean, y_std, fused=True, dtype=torch.float32, eps=TRAIN_EPS)
    model.mesh = mesh                   # as reg tr with SNNGP_MESH_DEVICES
    model.likelihood.chol_fn = functools.partial(blocked_cholesky, block=512)
    (loss, names, g), t = _timed(lambda: _loss_and_grads(model))
    g64 = train_gradients["g64"]
    e = ((g - g64).norm() / g64.norm()).item()
    bar = 2.0 * max(train_gradients["kernel_err"], 1e-6)
    print(f"[mesh] SPR.loss on the mesh at N={SERVE_N}: loss {loss:.8f}, value and "
          f"gradients {t:.3f} s; gradient rel err {e:.3e} against float64 (single-device "
          f"fp32 {train_gradients['kernel_err']:.3e})")
    if not e <= bar:
        raise AssertionError(f"mesh gradient error {e:.3e} above {bar:.3e}")
    out["loss"] = (t, e)
    del model
    torch.cuda.empty_cache()

    xm, ym = _mlii_mesh_data()
    xm = torch.as_tensor(xm, device="cuda")
    for method, ab in (("gp", None), ("tp", MLII_AB)):
        (loss, grads), t = _timed(lambda: distributed_mlii_value_and_grad(
            _mesh_aug(), xm, ym, mesh, last_w_std=MLII_HYPER["last_w_std"], eps=MLII_EPS,
            ab=ab))
        ref = refs["mlii"][method]
        for name in ("single", "f64"):
            want_loss, want = ref[name]
            rel = {k: abs(grads[k] - v) / abs(v) for k, v in want.items()}
            print(f"[mesh] distributed_mlii_value_and_grad {method} at N={MESH_MLII_N} "
                  f"(cond(S) {ref['cond']:.2e}): {t:.3f} s; against {name}: loss {loss:.7f} / "
                  f"{want_loss:.7f}; grad rel " + " ".join(
                      f"{k} {v:.2e}" for k, v in sorted(rel.items())))
            if not abs(loss - want_loss) <= 1e-5 * abs(want_loss):
                raise AssertionError(f"distributed ML-II {method}: loss {loss} against "
                                     f"{name} {want_loss}")
            for k, v in want.items():
                if not abs(grads[k] - v) <= 1e-6 + 2e-3 * abs(v):
                    raise AssertionError(f"distributed ML-II {method} d/d{k}: {grads[k]} "
                                         f"against {name} {v}")
        out[f"mlii {method}"] = t
    return out


# -- classification and the pipeline on the mesh (K3-K7, once per shard) ---------------

def _mesh_elbo_cases():
    """(label, method, network, inducing images, batch, shards) of phase 26's
    gradient gates: phase 9's, 12's and 15's references. Myrtle's batch of
    MYRTLE_CHECK_NB takes MESH_MYRTLE_SHARDS shards."""
    from snngp_torch.cli.classification import _inducing_init

    x, y, z, num_class = _svsp_data()
    z_small, _ = _inducing_init(x, y, num_class, MYRTLE_CHECK_NI)
    return (x, y, num_class,
            (("cnn svgp", "svgp", "cnn", z, SVSP_NB, MESH_SHARDS),
             ("cnn svtp", "svtp", "cnn", z, SVSP_NB, MESH_SHARDS),
             ("resnet svgp", "svgp", "resnet", z, SVSP_NB, MESH_SHARDS),
             ("myrtle svgp", "svgp", "myrtle", z_small, MYRTLE_CHECK_NB,
              MESH_MYRTLE_SHARDS)))


def phase26_mesh_elbo(checks, single):
    """The batch-sharded ELBO (``SVSP.loss(..., mesh=)``) on shards of
    cuda:0 at the CIFAR shape: its gradient on one batch against the float64
    references of phases 9, 12 and 15 (gate: within 2x the single-device
    fp32 kernel path's error), then MESH_ELBO_STEPS timed steps each of CNN
    svgp, CNN svtp with frozen inducing inputs, WideResNet svgp and Myrtle-5
    svtp on four shards (gates: finite losses and exactly the launches a
    step of row-panel Grams: k_bi and k_bb one launch a shard, k_ii one),
    each beside the single-device step of its phase."""
    import torch

    x, y, num_class, cases = _mesh_elbo_cases()
    out = {}
    for label, method, network, z, nb, shards in cases:
        ref = checks[label]
        model = _svsp_model(method, z, num_class, network=network, eps=1e-2)
        draws = _cast_draws(_svsp_draws(method, num_class, nb), torch.float32)
        xb = torch.as_tensor(x[:nb], device="cuda", dtype=torch.float32)
        yb = torch.as_tensor(y[:nb], device="cuda")
        (loss, g), t = _timed(lambda: _mesh_loss_and_grads(model, xb, yb, x.shape[0], draws,
                                                           _mesh(shards=shards)))
        g64 = ref["g64"]
        e = ((g - g64).norm() / g64.norm()).item()
        bar = 2.0 * max(ref["errs"]["kernel"], 1e-6)
        print(f"[mesh-cls] {label} ELBO on {shards} shards (batch {nb}, {z.shape[0]} "
              f"inducing): loss {loss:.8f}, {t:.3f} s; gradient rel err {e:.3e} against "
              f"float64 (single-device fp32 {ref['errs']['kernel']:.3e})")
        if not (math.isfinite(loss) and e <= bar):
            raise AssertionError(f"{label} on the mesh: loss {loss}, gradient error {e:.3e} "
                                 f"above {bar:.3e}")
        out[f"{label} gradient"] = e
        del model
        torch.cuda.empty_cache()

    x, y, z, num_class = _svsp_data()
    mesh = _mesh()
    blocks = 2 * MESH_SHARDS + 1           # k_bi and k_bb panels, k_ii
    configs = (("cnn svgp", "svgp", "cnn", True, {"conv_gram": blocks}, "svgp"),
               ("cnn svtp frozen", "svtp", "cnn", False,
                {"conv_gram": blocks, "conv_gram_grads": blocks}, "svtp frozen"),
               ("resnet svgp", "svgp", "resnet", True,
                {"resnet_tail": blocks * (1 + 3 * (SVSP_DEPTH > 1)),
                 "resnet_strided": 3 * blocks}, "resnet svgp"),
               ("myrtle svtp", "svtp", "myrtle", False,
                {"myrtle": blocks, "myrtle_grads": blocks}, "myrtle svtp"))
    for label, method, network, trainable, want, one in configs:
        got = _svsp_steps(f"mesh {label}", method, x, y, z, num_class, want, trainable,
                          network=network, steps=MESH_ELBO_STEPS, mesh=mesh)
        print(f"[mesh-cls] {label} step on {MESH_SHARDS} shards of one card "
              f"{got['step_ms']:.2f} ms against {single[one]['step_ms']:.2f} ms on one "
              "device (the shards run one after another: not a multi-card time)")
        out[label] = got
    return out


def _mesh_loss_and_grads(model, xb, yb, num_train, draws, mesh):
    """The ELBO on the mesh and its gradients, in _svsp_gradient_check's
    order (sorted parameter names), as one float64 vector."""
    import torch
    loss = model.loss(xb, yb, num_train, SVSP_SAMPLES, draws=draws, mesh=mesh)
    loss.backward()
    g = torch.cat([p.grad.double().flatten() for _, p in sorted(model.named_parameters())])
    return loss.item(), g


def _cls_args(argv):
    """``python -m snngp_torch --device cuda <argv>``'s parsed arguments."""
    import argparse
    import torch
    import snngp_torch.cli

    parser = argparse.ArgumentParser(prog="python -m snngp_torch")
    snngp_torch.cli.add_subparser(parser.add_subparsers(dest="command", required=True))
    args = parser.parse_args(argv)
    args.device = torch.device("cuda")
    return args


def phase27_cls_mesh(cls10):
    """``cls tr -m svtp -dn synthetic32 -e 1`` at phase 10's sizes through
    ``train_main(args, mesh=...)`` on four shards of cuda:0, then ``cls ts``
    of its checkpoint on one device (gates: the log says ``Mesh: 4 devices
    (batch-sharded ELBO)`` and its nELBOs are finite; the test NLL within
    phase 10's Monte Carlo tolerance of phase 10's run)."""
    from snngp_torch.cli.classification import train_main

    work = REPO / "build" / "chip_smoke" / "cls_mesh"
    shutil.rmtree(work, ignore_errors=True)
    args = _cls_args(["cls", "tr", "-m", "svtp", "-dn", "synthetic32", "-e", "1", "-ni",
                      str(SVSP_NI), "-nb", str(SVSP_NB), "-nh", str(SVSP_DEPTH), "-cr",
                      str(work), "-cn", "mesh", "-q"])
    t0 = time.perf_counter()
    train_main(args, mesh=_mesh())
    t_tr = time.perf_counter() - t0
    ckpt = work / "mesh"
    text = (ckpt / "train.log").read_text()
    nelbos = [float(ln.split("nELBO:")[1].split()[0]) for ln in text.splitlines()
              if "nELBO:" in ln and "NLL:" not in ln]
    if ("Traceback" in text or f"Mesh: {MESH_SHARDS} devices (batch-sharded ELBO)" not in text
            or not nelbos or not all(math.isfinite(v) for v in nelbos)):
        raise AssertionError(text)
    t0 = time.perf_counter()
    _run_cli(["--device", "cuda", "cls", "ts", "-dn", "synthetic32", "-cd", str(ckpt), "-nd",
              str(CLS_TEST_N), "-q"])
    t_ts = time.perf_counter() - t0
    nll = _cls_nll(ckpt / "test")
    diff = abs(nll - cls10["nll"]["cuda"])
    print(f"[mesh-cls] cls tr on {MESH_SHARDS} shards: {t_tr:.2f} s (one device, phase 10: "
          f"{cls10['times']['cuda']:.2f} s), last nELBO {nelbos[-1]:.5f}; cls ts on one "
          f"device {t_ts:.2f} s: NLL {nll:.5f} against phase 10's {cls10['nll']['cuda']:.5f}, "
          f"|diff| {diff:.2e} (MC tolerance {cls10['tol']:.2e})")
    if not diff <= cls10["tol"]:
        raise AssertionError(f"cls tr on the mesh: NLL {nll} against {cls10['nll']['cuda']}")
    return dict(nll=nll, tr_s=t_tr, ts_s=t_ts)


def _pipeline_data():
    """The pipeline's train / test images (seeded synthetic, 32 x 32 x 3) on
    the card, and its normalized targets, as ``cifar_myrtle.main`` makes
    them at MESH_CLS_N / MESH_CLS_TEST."""
    import torch
    from snngp_torch.examples import cifar_myrtle

    x, y = cifar_myrtle.load_images(MESH_CLS_N + MESH_CLS_TEST, 32, seed=0)
    y_mean, y_std = np.float32(np.mean(y[:MESH_CLS_N])), np.float32(np.std(y[:MESH_CLS_N]))
    x = torch.as_tensor(x, device="cuda")
    return x[:MESH_CLS_N], x[MESH_CLS_N:], (y - y_mean) / y_std, y_mean, y_std


def _pipeline_nll64(grams, data):
    """The pipeline's Student-t NLL from these fp32 Grams with the fit and
    the predictive in float64 (its defaults: eps 1e-4 absolute, a = b = 2,
    t-jitter and var floor 1e-6)."""
    import torch
    from snngp_torch.models import SPR, NNGPKernel, StudentTLikelihood, fit_spr
    from snngp_torch.nn.arch import get_myrtle_kernel

    k_dd, k_td, k_tt = grams
    x_train, _, y_n, y_mean, y_std = data
    kernel = NNGPKernel(lambda w, b, l: get_myrtle_kernel(MYRTLE_DEPTH, 1, "relu", w_std=w,
                                                          b_std=b, last_w_std=l),
                        MLII_HYPER["w_std"], MLII_HYPER["b_std"], MLII_HYPER["last_w_std"])
    eps_rel = 1e-4 / (float(np.trace(k_dd)) / MESH_CLS_N)
    model = SPR(kernel, StudentTLikelihood(2.0, 2.0), x_train.cpu().numpy(), y_n[:MESH_CLS_N],
                y_mean, y_std, eps=eps_rel).to(device="cuda", dtype=torch.float64)
    with torch.no_grad():
        fitted = fit_spr(model, gram=k_dd.astype(np.float64), var_floor=1e-6, t_jitter=1e-6)
        y_test = torch.as_tensor(y_n[MESH_CLS_N:], device="cuda", dtype=torch.float64)
        return float(fitted.test_nll_given(k_td.astype(np.float64),
                                           np.diagonal(k_tt).astype(np.float64), y_test))


def phase28_references():
    """Phase 28's references, run before its launch window: the pipeline at
    MESH_CLS_PIPELINE on one device (NLL) and its three Grams there, by
    ``myrtle_gram_tiled`` as the fused route assembles them."""
    from snngp_torch.examples import cifar_myrtle
    from snngp_torch.ops.myrtle_gram import myrtle_gram_tiled

    one = cifar_myrtle.main(["--device", "cuda", *MESH_CLS_PIPELINE])
    data = _pipeline_data()
    x_train, x_test = data[:2]
    kw = dict(depth=MYRTLE_DEPTH, act="relu", **MLII_HYPER)
    grams = (myrtle_gram_tiled(x_train, **kw), myrtle_gram_tiled(x_test, x_train, **kw),
             myrtle_gram_tiled(x_test, **kw))
    print(f"[mesh-pipeline] reference on one device: NLL {one['nll']:.6f}; phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in one["phases_s"].items()))
    return dict(nll=one["nll"], phases_s=one["phases_s"], grams=grams, data=data)


def phase28_pipeline_mesh():
    """``cifar_myrtle --fused on`` at MESH_CLS_PIPELINE (phase 17's sizes,
    no ML-II) with four shards of cuda:0 handed in (``main(argv, mesh=)``):
    the Grams as K7 row panels, the blocked factorization of ``SPR(mesh=)``."""
    from snngp_torch.examples import cifar_myrtle

    result = cifar_myrtle.main(["--device", "cuda", *MESH_CLS_PIPELINE], mesh=_mesh())
    print(f"[mesh-pipeline] on {MESH_SHARDS} shards of one card: NLL {result['nll']:.6f}; "
          "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in result["phases_s"].items()))
    if not math.isfinite(result["nll"]):
        raise AssertionError(f"pipeline on the mesh: NLL {result['nll']}")
    return result


def phase28_check(refs, result):
    """Phase 28's comparisons, run after the window: the gathered
    ``myrtle_gram_sharded`` Grams against the single-device ones (gate:
    KERNEL_REL_TOL of max|K|), and the NLL: within PIPELINE_RTOL of the
    single-device run (the mesh example's parity bar), or else each route's
    NLL against a float64 fit of its own Grams, the mesh route's error
    within 2x the single-device route's. Prints which gate held."""
    import torch
    from snngp_torch.ops.myrtle_gram import myrtle_gram_sharded
    from snngp_torch.parallel.mesh import gather

    x_train, x_test = refs["data"][:2]
    mesh = _mesh()
    kw = dict(depth=MYRTLE_DEPTH, act="relu", **MLII_HYPER)
    with torch.no_grad():
        grams = tuple(gather(myrtle_gram_sharded(a, b, mesh, **kw)).cpu().numpy()
                      for a, b in ((x_train, None), (x_test, x_train), (x_test, None)))
    for name, got, want in zip(("train", "cross", "test"), grams, refs["grams"]):
        e = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"[mesh-pipeline] gathered {name} Gram {got.shape}: rel err {e:.3e} against "
              "one device")
        if not e <= KERNEL_REL_TOL:
            raise AssertionError(f"mesh {name} Gram: rel err {e:.3e}")
    nll, one = result["nll"], refs["nll"]
    rel = abs(nll - one) / abs(one)
    f64_one, f64_mesh = (_pipeline_nll64(g, refs["data"]) for g in (refs["grams"], grams))
    err_one, err_mesh = abs(one - f64_one), abs(nll - f64_mesh)
    f64_bar = 2.0 * max(err_one, 1e-7 * abs(f64_one))
    print(f"[mesh-pipeline] NLL on the mesh {nll:.7f}, one device {one:.7f}: rel {rel:.3e} "
          f"(parity bar {PIPELINE_RTOL:g}); against float64 fits of each route's Grams "
          f"({f64_mesh:.7f}, {f64_one:.7f}): mesh {err_mesh:.3e}, one device {err_one:.3e}")
    if rel <= PIPELINE_RTOL:
        print("[mesh-pipeline] NLL gate: parity with one device holds")
    elif err_mesh <= f64_bar:
        print("[mesh-pipeline] NLL gate: parity missed; the float64 gate holds")
    else:
        raise AssertionError(f"pipeline NLL on the mesh {nll} against one device {one}: "
                             f"rel {rel:.3e}; float64 error {err_mesh:.3e} above {f64_bar:.3e}")
    return dict(rel=rel, err_mesh=err_mesh, err_one=err_one)


def mesh_cls_window(checks, single, cls10):
    """Phase 28's references, then phases 26-28 in their own launch window
    (K3-K7 and K7's tangent mode must launch, K1 and K2 must not), then
    phase 28's comparisons. Returns the window's launch counts."""
    refs = _phase("28 (references)", phase28_references)
    _reset_launches()                     # classification and pipeline on the mesh start here
    _phase(26, phase26_mesh_elbo, checks, single)
    _phase(27, phase27_cls_mesh, cls10)
    result = _phase(28, phase28_pipeline_mesh)
    counts = _read_launches("classification and pipeline on the mesh",
                            ["conv_gram", "conv_gram_grads", "resnet_tail", "resnet_strided",
                             "myrtle", "myrtle_grads"])   # end here
    if counts["gram"] or counts["gram_grads"]:
        raise AssertionError(f"the classification mesh launched {counts}; expected K3-K7")
    _phase("28 (check)", phase28_check, refs, result)
    return counts


# -- the finite-width ensemble and the paper figures (no kernel of K1-K7) -------------

@contextlib.contextmanager
def _log_times(records):
    """Records (host time, line) of every ``Logger.log`` call: ``ens tr``
    logs an epoch's train NLL after a host read of its loss, so the time
    between two lines is device time."""
    from snngp_torch.utils.training import Logger
    original = Logger.log

    def log(self, *args, **kw):
        records.append((time.perf_counter(), "".join(map(str, args))))
        return original(self, *args, **kw)

    Logger.log = log
    try:
        yield
    finally:
        Logger.log = original


def _epoch_seconds(records):
    """epoch -> seconds of its training steps (from the line before its
    ``Train NLL`` line, the last validation's, to that line)."""
    out = {}
    for (t0, _), (t1, line) in zip(records, records[1:]):
        if "Train NLL:" in line:
            out[int(line.split("]")[0].strip("[ "))] = t1 - t0
    return out


def _tf32_flags():
    import torch
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _ens_test(dirs, device, precision="highest"):
    """``ens ts`` of the members ``dirs`` through its entry point: (NLL,
    accuracy in %)."""
    import argparse

    import torch
    import snngp_torch.cli as cli

    parser = argparse.ArgumentParser()
    cli.add_subparser(parser.add_subparsers(dest="command", required=True))
    args = parser.parse_args(["ens", "ts", "-dn", "synthetic32", "-cd", *dirs, "-nd",
                              str(ENS_TEST_N), "-mp", precision, "-q"])
    args.device = torch.device(device)
    return args.func(args)


def _member_logits(dirs, device):
    """The members' averaged logits on ENS_TEST_N test images, as ``ens ts``
    computes them."""
    import torch
    from snngp_torch.cli import ensemble
    from snngp_torch.data.classification import get_test_dataset

    (x, _), _ = get_test_dataset("synthetic32", num_data=ENS_TEST_N, onehot=True)
    xb = torch.as_tensor(x.astype(np.float32), device=device)
    members = [ensemble.load_member(d, device) for d in dirs]
    with torch.no_grad():
        return torch.stack([layer.apply(p, xb) for layer, p in members]).mean(0).cpu().numpy()


def phase22_ensemble():
    """``ens tr`` at the JAX defaults' full width on the card, with ``-mp
    highest`` and ``-mp default`` (gate: finite valid NLLs; both TF32 flags
    off again after each); ``ens ts`` of the two members on the card and on
    the CPU (gate: test NLLs within rtol ENS_RTOL at ``highest``), and their
    averaged logits (gate: within ENS_RTOL of max |logit|: synthetic32's
    classes separate, so the trained members' NLL rounds to 0 in fp32 and
    says little)."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        dirs = []
        for precision in ("highest", "default"):
            records = []
            with _log_times(records):
                wall = _timed(lambda: _run_cli(["--device", "cuda", *ENS_TRAIN, "-mp", precision,
                                                "-cr", tmp, "-cn", precision]))[1]
            if _tf32_flags() != (False, False):
                raise AssertionError(f"ens tr -mp {precision} left TF32 {_tf32_flags()}")
            epochs = _epoch_seconds(records)
            last = [line for _, line in records if "Valid NLL:" in line][-1]
            nll = float(last.split("Valid NLL:")[1].split()[0])
            acc = float(last.split("Valid ACC:")[1].split()[0])
            if not math.isfinite(nll):
                raise AssertionError(f"ens tr -mp {precision}: valid NLL {nll}")
            print(f"[ens] tr -mp {precision}: {wall:.2f} s, epochs " + ", ".join(
                f"{e}: {s:.3f} s" for e, s in sorted(epochs.items()))
                + f"; best valid NLL {nll:.6f}, ACC {acc:.2f}")
            out[precision] = dict(wall=wall, epochs=epochs, nll=nll, acc=acc)
            dirs.append(str(Path(tmp) / precision))
        (cuda, t_cuda) = _timed(lambda: _ens_test(dirs, "cuda"))
        t0 = time.perf_counter()
        cpu = _ens_test(dirs, "cpu")
        t_cpu = time.perf_counter() - t0
        fast = _ens_test(dirs, "cuda", "default")
        print(f"[ens] ts of 2 members, {ENS_TEST_N} images: card {cuda} ({t_cuda:.2f} s), "
              f"CPU {cpu} ({t_cpu:.2f} s), card -mp default {fast}")
        if abs(cuda[0] - cpu[0]) > ENS_RTOL * abs(cpu[0]):
            raise AssertionError(f"ens ts NLL: card {cuda[0]} against CPU {cpu[0]}")
        if _tf32_flags() != (False, False):
            raise AssertionError(f"ens ts -mp default left TF32 {_tf32_flags()}")
        logits = {device: _member_logits(dirs, device) for device in ("cuda", "cpu")}
        scale = float(np.max(np.abs(logits["cpu"])))
        logit_err = float(np.max(np.abs(logits["cuda"] - logits["cpu"]))) / scale
        print(f"[ens] averaged logits, card against CPU: {logit_err:.2e} of max|logit| "
              f"{scale:.2f}")
        if logit_err > ENS_RTOL:
            raise AssertionError(f"ens logits: card {logit_err} from the CPU's")
    out["ts"] = dict(cuda=cuda, cpu=cpu, default=fast, logit_err=logit_err)
    return out


def phase23_figures():
    """The paper figures at the notebook's sizes on the card: each panel's
    seconds and KS statistic (gate: initial <= KS_INITIAL_MAX, last and full
    <= KS_TRAINED_MAX)."""
    from snngp_torch.examples import paper_figures as fig

    out = fig.main([*FIGURES, "--outdir", str(REPO / "build" / "figures")])
    panels = out["panels"]
    for part, panel in panels.items():
        print(f"[figures] {part}: {panel['seconds']:.2f} s, KS {panel['ks']:.4f} at test "
              f"idx {panel['idx']}")
    if panels["initial"]["ks"] > KS_INITIAL_MAX:
        raise AssertionError(f"initial KS {panels['initial']['ks']} > {KS_INITIAL_MAX}")
    for part in ("last", "full"):
        if panels[part]["ks"] > KS_TRAINED_MAX:
            raise AssertionError(f"{part} KS {panels[part]['ks']} > {KS_TRAINED_MAX}")
    return {part: dict(seconds=p["seconds"], ks=p["ks"]) for part, p in panels.items()}


def phase23_members_check():
    """FIG_CHECK_MEMBERS fully trained members from one host-drawn init (a
    CPU generator and the host sigma draws), FIG_CHECK_STEPS steps, on the
    card and on the CPU, in float32 and in float64. Gates, relative to max
    |f| of the CPU's float64 run: the card's float32 within 1e-4 of the
    CPU's float32; the card's float64 within 1e-10 of the CPU's. Each
    float32 run's distance from float64 is printed (it includes the
    rounding of the sigmas to float32)."""
    import torch
    from snngp_torch.examples import paper_figures as fig

    params = fig.init_members(torch.Generator().manual_seed(FIG_CHECK_SEED),
                              FIG_CHECK_MEMBERS, fig.WIDTH)
    sigmas = fig.sample_sigmas(FIG_CHECK_SEED, 1.0, 1.0, FIG_CHECK_MEMBERS)
    samples = {}
    for device in ("cuda", "cpu"):
        for dtype in (torch.float32, torch.float64):
            data = tuple(a.astype(np.float64 if dtype == torch.float64 else np.float32)
                         for a in fig._make_dataset())
            p = tuple(tuple(t.to(dtype) for t in layer) for layer in params)
            r, wall = _timed(lambda: fig.draw_corr(
                "full", alpha=1.0, beta=1.0, ensemble_size=FIG_CHECK_MEMBERS,
                train_steps=FIG_CHECK_STEPS, map_batch=FIG_CHECK_MEMBERS, device=device,
                dataset=data, sigmas=sigmas, params=p))
            samples[device, str(dtype)[6:]] = r["samples"].astype(np.float64)
            print(f"[figures] {FIG_CHECK_MEMBERS} members, {FIG_CHECK_STEPS} full steps, "
                  f"{device} {str(dtype)[6:]}: {wall:.2f} s")
    ref = samples["cpu", "float64"]
    scale = np.max(np.abs(ref))
    err = {key: float(np.max(np.abs(s - ref)) / scale) for key, s in samples.items()}
    card_cpu32 = float(np.max(np.abs(samples["cuda", "float32"] - samples["cpu", "float32"]))
                       / scale)
    print(f"[figures] against the CPU's float64, of max|f| {scale:.4f}: card float64 "
          f"{err['cuda', 'float64']:.2e}, card float32 {err['cuda', 'float32']:.2e}, CPU "
          f"float32 {err['cpu', 'float32']:.2e}; card float32 against CPU float32 "
          f"{card_cpu32:.2e}")
    if card_cpu32 > 1e-4:
        raise AssertionError(f"float32 members: card {card_cpu32} from the CPU")
    if err["cuda", "float64"] > 1e-10:
        raise AssertionError(f"float64 members: card {err['cuda', 'float64']} from the CPU")
    return dict(err=err, card_cpu32=card_cpu32)


# One process: ``python -m snngp_torch -f 0.05 --device cuda reg tr ...`` (run as
# __main__ by runpy, as ``python -m`` does), then allocations above and below
# the cap; then the same command under ``-f 0.5`` and an allocation above the
# first cap. Prints one JSON line.
FRACTION_PROBE = r"""
import json, runpy, sys
import torch

def cli(argv):
    sys.argv = ["snngp_torch", *argv]
    runpy.run_module("snngp_torch", run_name="__main__", alter_sys=True)

def alloc(share):
    try:
        torch.empty(int(share * total), dtype=torch.uint8, device="cuda")
        return "ok"
    except torch.cuda.OutOfMemoryError:
        return "oom"
    finally:
        torch.cuda.empty_cache()

total = torch.cuda.get_device_properties(0).total_memory
cmd = sys.argv[1:]
out = {}
cli(["-f", "0.05", *cmd, "-cn", "capped"])
out["capped"] = {"above 0.05": alloc(0.08), "below 0.05": alloc(0.02)}
cli(["--fraction=0.5", *cmd, "-cn", "half"])
out["half"] = {"above 0.05": alloc(0.3), "above 0.5": alloc(0.6)}
print(json.dumps(out))
"""


def phase29_fraction():
    """``python -m snngp_torch -f 0.05`` and ``--fraction=0.5`` on the card,
    in a process of their own: a ``reg tr`` of phase 6's flags completes
    under each cap (gate: finite NLLs); an allocation above the cap raises
    out-of-memory and one below it does not (gate)."""
    work = REPO / "build" / "chip_smoke" / "fraction"
    shutil.rmtree(work, ignore_errors=True)
    cmd = ["--device", "cuda", "reg", "tr", *CLI_TRAIN, "-t", "5", "-cr", str(work), "-dr",
           str(work / "data")]
    proc = subprocess.run([sys.executable, "-c", FRACTION_PROBE, *cmd], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the -f probe failed:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    nll = {name: _best_nll(work / name / "train.log") for name in ("capped", "half")}
    print(f"[fraction] -f 0.05: {out['capped']}, reg tr best NLL {nll['capped']:.5f}; "
          f"--fraction=0.5: {out['half']}, reg tr best NLL {nll['half']:.5f}")
    want = {"capped": {"above 0.05": "oom", "below 0.05": "ok"},
            "half": {"above 0.05": "ok", "above 0.5": "oom"}}
    if out != want or not all(math.isfinite(v) for v in nll.values()):
        raise AssertionError(f"-f caps: {out} (want {want}), NLLs {nll}")
    return dict(out, nll=nll)


def phase30_trace(late=False):
    """``snngp_torch.utils.profiling.trace`` around one K1 launch (K(x, x)
    of 2,048 x 16). Early in the process (gate) the trace file exists,
    names K1's kernel and ``trace`` does not warn. Late in it (``late``,
    after phase 29), torch.profiler can lose a capture's kernel records
    (PERF.md section 7; ``snngp_torch/tools/trace_repro.py --case idle``
    loses them with torch alone when captures come seconds apart): the
    gate is then that the trace names K1's kernel or ``trace`` warned that
    it lacks kernels, never a silent loss."""
    import tempfile
    import warnings

    import torch
    from snngp_torch.ops import gram as G
    from snngp_torch.utils.profiling import trace

    x = torch.as_tensor(np.random.RandomState(30).randn(2048, 16).astype(np.float32),
                        device="cuda")
    before = G.LAUNCHES["gram"]
    _sync()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.inference_mode(), trace(tmp) as logdir:
                G.mlp_gram(x, x, depth=DEPTH, act="relu", w_std=W_STD, b_std=B_STD,
                           last_w_std=LAST_W_STD)
        if G.LAUNCHES["gram"] != before + 1:
            raise AssertionError("the traced block did not launch K1 once")
        files = sorted(Path(logdir).glob("*.json"))
        text = files[-1].read_text() if files else ""
    named = "gram_kernel" in text
    lost = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)
            and "recorded" in str(w.message)]
    print(f"[trace] {'late' if late else 'early'}: {len(files)} trace file(s), {len(text)} "
          f"bytes; names gram_kernel: {named}; lost-kernels warning: {lost or None}")
    if not files or not ((named or lost) if late else (named and not lost)):
        raise AssertionError(f"the profiler trace of a K1 launch: named {named}, warned "
                             f"{lost} (late in the process {late})")
    return dict(files=len(files), bytes=len(text), named=named, warned=bool(lost))


def _torchrun(nproc, argv, timeout=DIST_TIMEOUT, env=None):
    """``python -m torch.distributed.run --standalone`` of dist_mesh.py with
    ``nproc`` ranks, in a session of its own (``env`` added to this
    process's environment): (exit code, output), the whole session killed
    past ``timeout`` (exit code None). torchrun stops the other ranks when
    one fails."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", str(REPO / "snngp_torch" / "tools" / "dist_mesh.py"),
           *argv]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, env={**os.environ, **(env or {})})
    try:
        out, _ = proc.communicate(timeout=timeout)
        return proc.returncode, out
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return None, out


def _dist_run(label, nproc, argv):
    """One gated group: its rank 0's JSON line; fails on a failed or hung
    rank, on a failed check, or when a kernel of DIST_KERNELS never
    launched."""
    code, out = _torchrun(nproc, argv)
    lines = out.splitlines()
    for line in lines:
        if line.startswith("[dist]"):
            print(f"[dist] {label}: {line[7:]}")
    result = [json.loads(line[12:]) for line in lines if line.startswith("[dist-json] ")]
    if code != 0 or not result:
        why = "timed out and was killed" if code is None else f"exited {code}"
        raise AssertionError(f"{label}: the group {why}:\n" + "\n".join(lines[-60:]))
    result = result[-1]
    missing = [k for k in DIST_KERNELS if result["launches"].get(k, 0) <= 0]
    if result["failed"] or missing:
        raise AssertionError(f"{label}: failed checks {result['failed']}, kernels never "
                             f"launched {missing}")
    return result


def phase31_dist(train_gradients, cnn_check):
    """The mesh across processes (``tools/dist_mesh.py`` under torchrun):
    DIST_RANKS gloo ranks on cuda:0, then one NCCL rank, each gated; then
    DIST_RANKS NCCL ranks on cuda:0, tried once and reported. Returns the
    gated groups' launch counts, summed over their ranks."""
    import torch

    torch.cuda.empty_cache()
    refs = REPO / "build" / "chip_smoke" / "dist_refs.npz"
    refs.parent.mkdir(parents=True, exist_ok=True)
    np.savez(refs, spr_g64=train_gradients["g64"].cpu().numpy(),
             spr_kernel_err=train_gradients["kernel_err"],
             elbo_g64=cnn_check["g64"].cpu().numpy(), elbo_kernel_err=cnn_check["errs"]["kernel"])
    common = ["--device", "cuda:0", "--refs", str(refs)]
    out = {"gloo": _dist_run(f"{DIST_RANKS} gloo ranks on cuda:0", DIST_RANKS,
                             ["--backend", "gloo", *common]),
           "nccl": _dist_run("1 NCCL rank", 1, ["--backend", "nccl", *common])}
    code, text = _torchrun(DIST_RANKS, ["--backend", "nccl", "--parts", "gram", "--gram-n", "4096",
                                        *common], timeout=120, env={"NCCL_DEBUG": "WARN"})
    lines = [line.strip() for line in text.splitlines() if line.strip()]
    said = [line for line in lines if any(w in line for w in ("NCCL", "nccl", "Error"))]
    print(f"[dist] {DIST_RANKS} NCCL ranks on cuda:0 (not gated): "
          f"{'timed out' if code is None else f'exit {code}'}; what it said:")
    for line in (said or lines)[-12:]:
        print(f"[dist]   {line[:300]}")
    for name, res in out.items():
        print(f"[dist] {name}: launches over the ranks {res['launches']}; checks "
              f"{json.dumps(res['checks'])}")
    return {k: out["gloo"]["launches"][k] + out["nccl"]["launches"][k]
            for k in out["gloo"]["launches"]}


def _kernel_entry(name, source, replaces, launches, rows, head, worst_abs):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": worst_abs,
            "ms": rows[head]["ms"], "plain_ms": rows[head]["plain_ms"],
            "bound_ms": rows[head]["bound_ms"], "bound_by": rows[head]["bound_by"],
            "library_ms": None, "variants": rows}


def _phase(number, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] phase {number}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "snngp_torch" / "csrc" / "gram.cu").is_file():
        print(f"chip_smoke: no snngp_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    import snngp_torch  # noqa: F401  (precision policy)

    t_start = time.perf_counter()
    _phase(0, phase0_setup)
    with torch.inference_mode():
        k1_rows, k1_abs = _phase(1, phase1_kernel_vs_plain)
    _phase(30, phase30_trace)
    with torch.inference_mode():
        data = _serving_data()
        _warm_up(data)
        _reset_launches()                 # serving path starts here
        _, serve_errs, serve_ref64 = _phase(2, phase2_serving, data)
    _phase(3, phase3_cli)
    serving = _read_launches("serve", ["gram"])   # serving path ends here

    x_train, cot = ml2_cotangent(data)
    with torch.inference_mode():
        k2_rows = _phase(4, phase4_k2_vs_plain, x_train, cot)
    del x_train, cot
    torch.cuda.empty_cache()
    _reset_launches()                     # training path starts here
    train_out = _phase(5, phase5_training, data)
    _phase(6, phase6_train_cli)
    training = _read_launches("train", ["gram", "gram_grads"])  # training path ends here

    _reset_launches()                     # regression extras start here
    with torch.inference_mode():
        _phase(18, phase18_extend, data)
    _phase(19, phase19_find_and_add_x)
    _phase(20, phase20_mlp_classifier)
    extras = _read_launches("regression extras", ["gram"])   # regression extras end here
    if any(n for name, n in extras.items() if name != "gram"):
        raise AssertionError(f"the regression extras launched {extras}; expected K1 only")

    with torch.inference_mode():
        k3_rows, k3_abs = _phase(7, phase7_k3_vs_plain)
    k4_rows = _phase(8, phase8_k4_vs_plain)
    checks = _phase("9 (gradient checks)", phase9_svsp_gradients)
    checks = {f"cnn {m}": v for m, v in checks.items()}
    torch.cuda.empty_cache()
    _reset_launches()                     # classification path starts here
    single = _phase(9, phase9_svsp)
    cls10 = _phase(10, phase10_cls_cli)
    classify = _read_launches("classify", ["conv_gram", "conv_gram_grads"])  # ends here

    with torch.inference_mode():
        k56_rows, k56_abs = _phase(11, phase11_k5_k6_vs_plain)
    checks["resnet svgp"] = _phase("12 (gradient check)", phase12_resnet_gradient)
    _reset_launches()                     # WideResNet classification path starts here
    single.update(_phase(12, phase12_resnet_svsp))
    _phase(13, phase13_resnet_cli)
    resnet = _read_launches("classify-resnet", ["resnet_tail", "resnet_strided"])  # ends

    k7_rows, k7_abs = _phase(14, phase14_k7_vs_plain)
    k7b_rows, k7b_abs = _phase("14 (bf16)", phase14_k7_bf16)
    checks["myrtle svgp"] = _phase("15 (gradient check)", phase15_myrtle_gradient)
    _reset_launches()                     # Myrtle classification + pipeline path starts here
    single.update(_phase(15, phase15_myrtle_svsp))
    _phase(16, phase16_myrtle_cli)
    pipeline = _phase(17, phase17_pipeline)
    _phase("17 (bf16)", phase17_bf16_pipeline)
    _phase(21, phase21_mlii)
    myrtle = _read_launches("myrtle", ["myrtle", "myrtle_grads", "myrtle_bf16"])  # ends here
    _phase("17 (full tier)", phase17_full_tier, pipeline["hyper"])
    _phase("21 (gradient check)", phase21_mlii_gradient)
    lean = _lean_data()
    with torch.inference_mode():
        _phase("24 (K1 rows)", phase24_k1_rows, lean)
        mesh_refs = _phase("25 (references)", phase25_references)
    _reset_launches()                     # lean and mesh regression start here
    with torch.inference_mode():
        _phase(24, phase24_lean, data, serve_ref64, serve_errs["kernel"], lean)
    _phase(25, phase25_mesh, data, mesh_refs, train_out["gradients"])
    lean_mesh = _read_launches("lean and mesh regression",
                               ["gram", "gram_grads", "myrtle_grads"])   # end here
    del lean, mesh_refs
    torch.cuda.empty_cache()
    mesh_cls = mesh_cls_window(checks, single, cls10)
    cnn_check = checks["cnn svgp"]
    del checks
    torch.cuda.empty_cache()
    _reset_launches()                     # the ensemble and the figures start here
    _phase(22, phase22_ensemble)
    _phase(23, phase23_figures)
    _phase("23 (members check)", phase23_members_check)
    finite = _read_launches("ensemble + figures", [])   # end here
    if any(finite.values()):
        raise AssertionError(f"the ensemble and the figures launched {finite}; expected none")
    _phase(29, phase29_fraction)
    dist = _phase(31, phase31_dist, train_out["gradients"], cnn_check)   # launches in the ranks
    del cnn_check
    _phase("30 (late)", phase30_trace, True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    k1 = _kernel_entry("gram (K1, fused NNGP Gram)", "snngp_torch/csrc/gram.cu",
                       "snngp/ops/pallas/gram.py:180",
                       serving["gram"] + training["gram"] + extras["gram"]
                       + lean_mesh["gram"] + dist["gram"], k1_rows,
                       f"mlp/relu/{HEAD_SHAPE}", k1_abs)
    k2 = _kernel_entry("gram_grads (K2, scalar-tangent Gram backward, fused contraction)",
                       "snngp_torch/csrc/gram.cu", "snngp/ops/pallas/gram.py:249",
                       training["gram_grads"] + lean_mesh["gram_grads"] + dist["gram_grads"],
                       k2_rows,
                       f"mlp/relu/{HEAD_SHAPE}/random",
                       max(r["abs_err"] for r in k2_rows.values()))
    k3 = _kernel_entry("conv_gram (K3, fused CNN NNGP Gram; one warp streams a pair's rows "
                       "through registers, symmetric launch for K(x, x))",
                       "snngp_torch/csrc/conv_gram.cu",
                       "snngp/ops/pallas/conv_gram.py:64",
                       classify["conv_gram"] + mesh_cls["conv_gram"] + dist["conv_gram"],
                       k3_rows,
                       K34_HEAD, k3_abs)
    k4 = _kernel_entry("conv_gram_grads (K4, scalar-tangent CNN Gram backward, fused "
                       "contraction; one warp streams a pair's rows through registers, "
                       "symmetric launch for K(x, x))", "snngp_torch/csrc/conv_gram.cu",
                       "snngp/ops/pallas/conv_gram.py:180",
                       classify["conv_gram_grads"] + mesh_cls["conv_gram_grads"]
                       + dist["conv_gram_grads"],
                       k4_rows, K34_HEAD, max(r["abs_err"] for r in k4_rows.values()))
    k5 = _kernel_entry("resnet_tail (K5, fused WideResNet stride-1 residual blocks; one warp "
                       "streams a pair's rows through registers, symmetric launch for K(x, x))",
                       "snngp_torch/csrc/resnet_conv_gram.cu",
                       "snngp/ops/pallas/resnet_conv_gram.py:130",
                       resnet["resnet_tail"] + mesh_cls["resnet_tail"] + dist["resnet_tail"],
                       k56_rows["K5"], K5_HEAD, k56_abs["K5"])
    k6 = _kernel_entry("resnet_strided (K6, fused WideResNet stride-2 group-boundary block, "
                       "at the reduced resolution; one warp streams a pair's rows through "
                       "registers, symmetric launch for K(x, x))",
                       "snngp_torch/csrc/resnet_conv_gram.cu",
                       "snngp/ops/pallas/resnet_conv_gram.py:54",
                       resnet["resnet_strided"] + mesh_cls["resnet_strided"]
                       + dist["resnet_strided"],
                       k56_rows["K6"], K6_HEAD, k56_abs["K6"])
    k7 = _kernel_entry("myrtle (K7, fused Myrtle-5/7/10 Gram, Delta-slab recursion)",
                       "snngp_torch/csrc/myrtle_gram.cu",
                       "snngp/ops/pallas/myrtle_gram.py:278",
                       myrtle["myrtle"] + lean_mesh["myrtle"] + mesh_cls["myrtle"]
                       + dist["myrtle"],
                       k7_rows["fwd"], K7_HEAD, k7_abs["fwd"])
    k7t = _kernel_entry("myrtle_grads (K7 scale-tangent mode, dK/dw and dK/db in one pass; "
                        "stage 1 streamed through registers, 16 warps, one block per pair "
                        "of K(x, x))",
                        "snngp_torch/csrc/myrtle_gram.cu",
                        "snngp/ops/pallas/myrtle_gram.py:278",
                        myrtle["myrtle_grads"] + lean_mesh["myrtle_grads"]
                        + mesh_cls["myrtle_grads"] + dist["myrtle_grads"],
                        k7_rows["tangents"], K7_HEAD, k7_abs["tangents"])
    k7b = _kernel_entry("myrtle_bf16 (K7 with a bf16 pair state: myrtle_gram_kernel's bf16 "
                        "variant, fp32 arithmetic rounded to bf16 at the plain version's "
                        "points, fp32 pools and GAP)",
                        "snngp_torch/csrc/myrtle_gram.cu",
                        "snngp/ops/pallas/myrtle_gram.py:278",
                        myrtle["myrtle_bf16"] + lean_mesh["myrtle_bf16"]
                        + mesh_cls["myrtle_bf16"] + dist["myrtle_bf16"], k7b_rows, K7_HEAD,
                        k7b_abs)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7, k7t, k7b]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
