#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use).  Phases,
each printing a line:

1. ``device`` — the card's name, then ``nvidia-smi``'s name and power limit.
2. ``build`` — the ten kernels compiled for ``sm_90a`` (time, ptxas
   report).
3. ``kernels`` — ``heap_kmin``, ``heap_sift`` and ``heap_insert`` run on
   CUDA tensors at the main path's shapes (4,000,000 keys; K = 1 and
   K = 4 shards; c_max = 16) over seeded random heaps and batches — empty
   heaps, ``ne > size``, ``m = 0`` shards, chunks crossing a level
   boundary, duplicate keys — and, past ``C_MAX``, ``heap_insert`` at
   widths 1, 32, 33 and 64 (near-empty heaps whose batch takes several
   level-chunks among them) and ``heap_sift`` with 33, 64 and 1,024
   cursors on real frontiers (:func:`wide_cases`), ``heap_kmin`` at
   c_max 33 and 64, on a heap whose smallest keys run down one path and on
   one topped with -0.0 and +0.0 (:func:`kmin_cases`), each result held
   element-wise (exactly: keys are only compared and moved) against the
   kernel's plain PyTorch version on the same inputs; then per-launch
   times from CUDA events around 30 back-to-back launches (median of 5
   such windows), the plain version's time, the bound, and for
   ``heap_kmin`` the ``torch.topk`` yardstick.  ``python3 chip_smoke.py
   --heap`` runs phases 2 and 3 alone.
4. ``pq-single`` — ``pc_priority_queue(BatchedPriorityQueue(...))`` and
5. ``pq-sharded`` — ``pc_sharded_priority_queue(..., n_shards=4)``: 8
   client threads of 50/50 insert/extract_min over 4,000,000 initial keys,
   with the kernel launch counts of that run, conservation of the
   multiset, the heap property of every shard, and a seeded single-thread
   replay of 240 combined batches through the kernel pass and the plain
   pass (both on the card, bit-equal after every batch) against
   ``SequentialHeap``.
   ``megapass`` (after phase 5, on the pq-sharded queue) — the PQ's
   rounds as packed device rows, one CUDA-graph replay a dispatch:
   (a) 40 seeded round lists (update rounds of 1 to 3 x C_MAX ops with
   repeated keys, ties, -0.0 and subnormals; ``peek_min`` rounds; empty
   rounds; 1 to 32 rows; 8 lists on a near-empty heap, where extracts
   pass a shard's size) through the queue (replay), through
   ``_sharded_mixed_rows`` on a clone (eager) and with the plain phases
   on a clone: heaps, outs and every handle's answers bit-equal, pairs of
   dispatches consumed in reverse, ``memory_reserved`` before and after
   the captures; (b) under ``one_fetch``, a dispatch and its handles make
   one blocking fetch and no other sync, one replay, and the heap
   kernels' counts rise by the captured launches; (c)
   ``pc_megapass_priority_queue`` over 4,000,000 keys, 8 threads x 200
   ops of 45 % insert, 45 % extract_min, 10 % peek_min, megapass on and
   off, every dispatch replayed through ``SequentialBatchedPQ``; (d) host
   and device ms of one dispatch at 1, 4, 8 and 16 rows, replayed and
   eager, and the capture's ms; (e) C4 on the card: ``heap_kmin``
   captured once and replayed at ne = 1, 5 and 16, ``sorted_merge``
   captured once and replayed twice on new inputs, both equal to their
   plain versions, and the merge's epoch field spent on the card.
   ``python3 chip_smoke.py --megapass`` runs phase 2 and this phase
   alone.
6. ``label_prop`` kernel checks — seeded graphs at 1,000,000 vertices
   (the graph's half-populated tree edge buffer with junk in its invalid
   slots, (0,0) padding + self-loops + duplicate edges, isolated
   vertices, an empty edge set, a chain of n vertices, a forest, the
   on-device gates, the contracted-merge form at the graph's 33 pending
   slots and on both sides of ``SMALL_E``, the union-find form): every
   step of every fixpoint with ``max_iters = 1`` (the step body; its
   count is the propagation steps printed), every whole fixpoint (the
   fixpoint body) in 3 shuffled edge orders, every merge in 3 orders of
   its live slots and every union-find batch in 3 orders, each held
   element-wise (exactly) and by its return value against the plain
   version; then the per-launch times at the graph's shape of the full
   rebuild (by the fixpoint body and by the step body), the chain, one
   step, the merge, 16 unions and a gated-off launch of each body, the
   plain versions' and the bounds.  ``python3 chip_smoke.py --label-prop`` runs phases 2 and
   6 alone.
7. ``graph`` — ``batched_read_optimized(DeviceGraph(...))`` (bench_graph's
   ``PC-K4`` row): 1,000,000 vertices, one random tree with half its
   999,999 edges written from numpy (:func:`tree_graph`), 8 client threads of 90% ``connected`` and
   5% each insert/delete of a tree edge; the kernel launch count, full
   rebuilds and fast merges of that run, per-edge-class conservation,
   final labels against the union-find oracle, and a seeded replay of
   combined update+read batches through the kernel pass and the plain
   pass (every state field bit-equal after each batch, answers equal to
   the port's ``DynamicGraph``), with a check that a read pass makes ONE
   blocking device-to-host transfer (any other sync raises under
   ``torch.cuda.set_sync_debug_mode("error")``).
8. ``unionfind`` — ``pc_union_find(BatchedUnionFind(1,000,000, c_max=16))``:
   8 threads of bench_unionfind's mix at 90% reads; launch count, final
   labels against the oracle of every union, and a replay through the
   kernel pass and the plain pass against ``SequentialUnionFind``.
9. ``sorted_merge`` kernel checks — seeded merge-compact inputs at the
   map's per-shard capacity (253,120 slots, K = 4 and K = 1), at N = 1000
   and one either side of the kernel's tile (2,047 and 2,049): keep all /
   none / ≤ 16 deletions / random half, b_count 0, 1 and 16, junk
   (unsorted, ±inf, NaN) in dropped slots and dead lanes, empty A, merged
   length exactly N, a raw -0.0 and flushed subnormal keys, the B run
   below or above all of A, and past 2,048 slots B runs of 1,024 lanes;
   each launch bit-equal to the plain version, the small ones to the
   numpy oracle too; then per-launch times on a full map pass at the map
   phase's fill (250,000 keys a shard, 16 deletions and 16 new keys) and,
   at the same shape, keep-none and empty A.  ``python3 chip_smoke.py
   --merge`` runs phases 2 and 9 alone.
10. ``map`` — ``pc_sharded_map`` (K = 4 key-range shards over [0, 1000),
   c_max = 16) over 1,000,000 keys drawn as bench_map's ``_items``, 8
   threads of bench_map's mix at 90% reads; sorted_merge launches, size
   conservation, sorted in-range shards, a 150-batch replay of the
   registry's mixes through the kernel pass and the plain pass (every
   ``MapState`` field bit-equal, answers equal to ``SequentialSortedMap``,
   every 10th batch with one blocking fetch, final contents equal to the
   oracle's), ``range_sum`` against the float64 oracle (see
   :func:`range_sum_check` and :func:`range_sum_exact_probes`), and
   ``pc_megapass_map`` against its alternating twin.
11. ``sketch`` — ``pc_sharded_sketch`` (K = 4 hash shards, c_max = 16,
   topk_max = 8) over 1,000,000 counters drawn as bench_sketch's
   ``_items``, 8 threads of bench_sketch's mix at 90% reads; exact
   conservation of the total and of the distinct count, the 2^24
   exactness precondition, and a 100-batch replay through the kernel pass
   and the plain pass against ``SequentialSketch``.
   ``placement`` (after phase 11) — the placement layer (DESIGN.md §18)
   on a one-rank NCCL group (one card allows no other mesh; the machine
   has no network, so ``NCCL_SOCKET_IFNAME=lo`` unless set, printed):
   stacked and ``MeshPlacement`` twins, each built the same way, (a) of
   the K = 4 PQ at 4,000,000 keys: 240 seeded batches, answers and
   gathered heaps bit-equal after every batch and equal to
   ``SequentialHeap``, the heap kernels' launches equal, every 20th mesh
   pass under ``one_fetch``; ``pc_sharded_priority_queue(placement=)``
   under 8 threads x 200 ops, conservation and the heap property; (d)
   12 ``mixed_rounds`` lists of up to 8 rows through both PQ twins,
   bit-equal, no graph captured on the mesh twin; (f) one ``all_gather``
   of (4, 16) f32 and of (1, 10⁶) i32 and one ``all_reduce`` timed on a
   twin's group; (b) of the map at 10⁶ keys, K = 4: 60 batches of the
   bench mix, answers (``range_sum`` included) and gathered tables
   bit-equal, ``sorted_merge``'s launches equal, ``mixed_rounds``; (c)
   of the graph built from the graph phase's state (10⁶ vertices, not
   prepopulated again): 30 batches with deletes (full rebuilds), every
   field bit-equal, the labels equal to the union-find oracle,
   ``label_prop`` launched 3 times a mesh read pass that may rebuild
   (the block fixpoint, the star merge, the contracted merge), once an
   insert-only one (the merge: the host's bound skips the collective),
   and 2 times a stacked one; (e) the serve CLI with ``--mesh-shards 4``
   on ``pq``, ``map`` and ``graph``, each request served once, on ``pq``
   under ``--faults standard`` too (a takeover rebuilds the placed
   deadline PQ on its group), ``decode`` with its deadline PQ placed, the
   other structures refused.  ``python3
   chip_smoke.py --placement`` runs phase 2 and this phase alone (the
   graph then built from numpy, :func:`tree_graph`).

12. ``flash_attention`` kernel checks — the kernels (bf16: tensor cores;
   f32: CUDA cores) against their plain version tiled like the kernel
   (``KERNEL_BLOCKS[dtype]``) on every case of the CPU tests and
   the bf16 kernel's edges (``ATTN_CASES``: GQA, causal and not, windows
   narrower than a tile, softcaps, ``q_offset``, ``kv_len < Skv``,
   ``hd_v != hd``, head dims 8 to 256, sequences one off each tile edge)
   and at the five model shapes (Qwen2-0.5B's scoring, (4, 4,096, 14/2
   heads, 64), causal; gemma2's, (2, 8,192, 8/4 heads, 256), window
   4,096, cap 50; RecurrentGemma's local layer, (1, 8,192, 10/1 heads,
   256), window 2,048; HuBERT's, (8, 1,500, 16/16 heads, 80),
   non-causal; llama4's, (2, 4,096, 40/8 heads, 128), causal, a GQA
   group of 5), each in f32 and in bf16, within the reference's
   tolerances (2e-5 f32, 2e-2 bf16; TF32 off) and in bf16 each output
   row within 2^-6 of its norm (``ATTN_ROW_TOL``); then at the five shapes
   in bf16 the kernel's ms (the CUDA-event method above), the plain
   version's and the bound (the unmasked pairs' FLOP over 989 TFLOP/s
   against q, k, v and o over 3.35 TB/s), and at Qwen2's, HuBERT's and
   llama4's SDPA's (``is_causal`` as the shape, ``enable_gqa``: the
   library yardstick, never called by the port).
13. ``model`` — Qwen2-0.5B at full width (24 layers, 494 M parameters,
   random bf16 weights from ``--seed``): ``lm.loss_fn`` and
   ``model_apply(mode="train")`` with ``attention_impl="pallas"`` on
   4 x 4,096 tokens, 24 kernel launches a forward; then
   ``DecodeExecutor(max_batch=8)`` answering 8 requests of 512-token
   prompts and 32 new tokens, in bf16 (timed) and with f32 weights and
   cache.  The checks and their tolerances are :func:`scoring`'s and
   :func:`model_phase`'s: the loss within 5e-3 of the plain path's, each
   layer's attention output within 2e-2 of the plain path's on the same
   bf16 input, f32 logits (and f32 decode steps) within 1e-4 of
   max|logit| of the plain path (the kernel-path forward), bf16 logits and
   bf16 decode steps no further from the f32 forward than 1.5x the bf16
   plain path (forward).  A 24-layer random-weight model in bf16 sits
   ~2 % of max|logit| off its f32 forward on either attention path, and
   the two bf16 paths as far apart, so bf16 logits are held against that
   noise, not to a fixed 2e-2.
14. ``serve`` — the serving layer on the ``model`` phase's Qwen2-0.5B
   weights: (a) ``PCScheduler(DecodeExecutor(max_batch=8, max_len=545))``
   under 8 pc-async sessions of 4 requests (512-token prompts, 32 new
   tokens, bf16 cache) and ``SerialScheduler`` over the same executor on 8
   of them — requests/s, tokens/s, device steps, mean batch and the
   scheduler's counters; every request served once in batches of ≤ 8,
   mean batch > 1, and every PC batch replayed through the executor with
   bit-equal tokens; then 8 x 2 requests at tier device with the pipeline
   on and off, timing the ordering passes' blocking fetches; (b) 64
   requests with seeded deadlines published behind a gated step (tier
   device, ``rounds_cap`` 4): each ordering pass's choice ascends by key,
   and one ordering pass makes one blocking fetch; (c) the ``pq`` workload
   through ``StructureExecutor`` over K = 4 shards holding the pq phases'
   4,000,000 keys, 8 sessions x 200 requests at 0 % reads (the PQ's only
   read, ``values``, dumps the whole heap), every applied batch replayed
   through ``spec.make_host`` (answers by ``spec.result_ok``, the final
   multiset equal); (d) ``serve.main`` for every registered workload at
   the registry's ``serve_kw`` sizes (``--scheduler pc-async``: ``graph``
   and ``unionfind`` run ``label_prop``, ``map`` and ``sketch``
   ``sorted_merge``) and on ``pq`` with ``--faults standard`` (a combiner
   takeover), and on ``pq`` with ``--megapass``, plain and with
   ``--faults standard``, every request applied once; the deadline PQ's
   graph replays are printed.  ``python3 chip_smoke.py
   --serve`` runs phases 2 and 14 alone, on fresh random weights.
15. ``gemma2`` — Gemma2-2B at full width (d_model 2,304, head dim 256,
   vocab 256,000), 2 layers (one local, one full): its scoring forward on
   8,192 tokens held as the model's; the window, both softcaps, the
   sandwich norms, gelu-tanh and the scaled embedding on the kernel path.
16. ``linear_scan`` kernel checks — ``rwkv6_scan`` (the per-token body
   below 16 tokens, the two-level chunked body on the tensor cores from
   16 on) against its plain version (the TPU kernel's chunked factored
   form) and the exact scan of ``ref.py`` on every case of the CPU tests
   (``RWKV_CASES``: S not a multiple of the chunk, chunks 16 to 64, S = 1,
   nonzero ``state0``), the strong-decay case (|log w| = 1, chunk 32), the
   tail lengths 15, 17, 63, 65 and 127, rows staged by plain loads (hd 12,
   views one element into their storage) and the phases' shapes (RWKV-6
   3B's scoring (4, 4,096, 40, 64) and serving prefill (8, 512, 40, 64),
   nonzero ``state0``), each with f32 and with bf16 r, k, v, within the
   reference's tolerances (y within 1e-4 of max|y|, S_T atol 1e-3 / rtol
   1e-4); decays past the plain version's domain (|log w| = 4, w0 over
   [-6, 1.5], 5 % of w exactly 0) against the exact scan alone;
   ``rglru_scan`` bit-equal to its plain version and to the exact scan on
   every CPU case, at RecurrentGemma's shapes ((1, 8,192, 2,560),
   (8, 512, 2,560)) and on the ring's ragged layouts (``RGLRU_RAGGED``:
   R not a multiple of 4, views one element into their storage, S = 1,
   S not a multiple of a stage, B x R below one CTA's channels, a short
   last channel tile); then at the main shapes each kernel's ms (the
   CUDA-event method above), the plain version's and the bound (no single
   PyTorch call computes either recurrence: no library yardstick),
   ``rglru_scan`` at the serving prefill shape, and ``rwkv6_scan`` at
   the serving prefill and decode shapes, at B = 3 and 6, and its
   per-token body alone at the scoring and prefill shapes.  The ``build``
   line gives ``rglru_scan``'s dynamic shared memory a CTA beside
   ptxas's registers and spills.
   ``python3 chip_smoke.py --scan`` runs phases 2, 16 and 23 (a) alone.
17. ``rwkv6`` — RWKV-6 3B at full width and depth (32 layers, d_model
   2,560, 40 heads of 64, d_ff 8,960, vocab 65,536, 2,913,405,440
   parameters, random bf16 weights from ``--seed``): the scoring forward
   on 4 x 4,096 tokens (32 ``rwkv6_scan`` launches a forward) and
   ``DecodeExecutor(max_batch=8)`` on 8 requests of 512-token prompts and
   32 new tokens (32 launches a decode step), with the ``model`` phase's
   checks, the plain path being the mixers' seam pointed at the plain
   scans (:func:`plain_scans`); the largest sum |log w| over a 64-token
   chunk that the layers hand their scans (:func:`decay_probe`).  The random model is ill-conditioned at
   its first tokens, so its f32 logits are held to 1e-4 from position
   n_layers + 32 on and the first positions, like its f32 decode steps
   (at the model's f32 floor, ~1e-4 on the plain path too), to 1.5x the
   distance of two plain f32 paths (:func:`scoring`, :func:`model_phase`).
18. ``recurrentgemma`` — RecurrentGemma-2B at full width (d_model 2,560,
   d_rnn 2,560, 10 query heads and 1 KV head of 256, window 2,048, d_ff
   7,680, vocab 256,000), one period deep (rglru, rglru, local attention;
   912,309,760 parameters): scoring on 1 x 8,192 tokens (2 ``rglru_scan``
   and 1 ``flash_attention`` launches a forward), serving 8 x (512 + 32),
   with the same checks.  The RG-LRU ``lam`` is redrawn so the recurrence
   carries state (:func:`slow_decay`).
19. ``llama4`` — Llama-4-Scout at full width (d_model 5,120, 40/8 heads of
   128, 16 experts top-1 of d_ff 8,192 and one shared expert, vocab
   202,048), 2 of its 48 layers (5,438,694,400 parameters; all 48 would
   be ~107 B): scoring 2 x 4,096 (2 ``flash_attention`` launches a
   forward), serving 8 x (512 + 32), with the ``model`` phase's checks;
   the MoE's routing is compared before the logits (:func:`moe_probe`,
   :func:`scoring`, :func:`model_phase`): the f32 kernel path picks the
   plain path's experts wherever the top-k margin exceeds 1e-6, and the
   bf16 checks keep the positions routed and kept alike; serving is
   timed at the config's capacity factor and checked at
   ``capacity_factor = n_experts``.
20. ``deepseek`` — DeepSeek-V2-Lite at full width (d_model 2,048, 16 MLA
   heads: kv_lora 512, rope 64, nope 128, v 128; the dense first layer of
   d_ff 10,944; 64 experts top-6 of d_ff 1,408 and two shared; vocab
   102,400), the prefix and 7 MoE layers: scoring 4 x 4,096, serving as
   ``llama4``; its forward launches no hand-written kernel (MLA attends
   with the blockwise attention, as the reference), checked.
21. ``vision`` — Llama-3.2-Vision at full width (d_model 4,096, 32/8
   heads, d_ff 14,336, vocab 128,256), 2 periods (10 layers, 2 of them
   cross-attention): scoring 2 x 4,096 tokens, each row with 1,601 seeded
   image embeddings (8 ``flash_attention`` launches a forward); serving
   8 x (512 + 32) through ``make_prefill`` with the image embeddings and
   32 ``make_decode_step`` steps (:func:`serve_steps`).
22. ``hubert`` — HuBERT-XLarge at full width and depth (48 layers,
   d_model 1,280, 16 heads of 80, non-causal, GELU MLP of 5,120, vocab
   504, the untied head): scoring 8 x 1,500 seeded frame embeddings (48
   non-causal ``flash_attention`` launches a forward); encoder-only, no
   serving.
   ``python3 chip_smoke.py --families`` runs phases 2 and 19-22 alone.
23. ``train`` — the training path through the port's ``train()`` entry
   point (:func:`train_phase`): (a) the backward kernels
   ``rglru_scan_bwd`` (at (1, 8,192, 2,560) and (8, 512, 2,560)) and
   ``rwkv6_scan_bwd`` (at (4, 4,096, 40, 64), (8, 512, 40, 64), S = 9
   and a narrow head, (2, 300, 40, 16), whose idle row groups still run)
   against their plain backwards on seeded inputs with decays
   near 0 and near 1 and nonzero initial states — ``rglru_scan_bwd`` bit
   for bit, ``rwkv6_scan_bwd`` within 2x the f32 plain backward's own
   error against f64 — and, below the first shape, against autograd
   through a forward; each one's ms, plain ms and bound by bytes; (b)
   Qwen2-0.5B, RWKV-6 3B and RecurrentGemma-2B at full width and depth,
   20 steps each (10 in the full run: ``RUN_TRAIN_STEPS``) of the
   pipeline's batches with remat on, bf16 weights
   and lr 1e-3 (``TRAIN_RUNS``): loss first and last (it must fall), step
   ms, tokens/s, peak memory, the launches of the scans and their
   backwards (each > 0 where the model has such layers) and one profiled
   step (not in the full run); (c) an f32 copy of each recurrent model at full width, reduced
   depth: the loss and every gradient leaf through the kernels against
   the plain scans, within 4x the two plain paths' distance; (d)
   Qwen2-0.5B crashed and resumed from its checkpoint, its final loss
   within 2e-3 of an uninterrupted run's; (e) ``flash_attention``
   refuses a gradient; (f) the other families at full width, 10 steps (8
   in the full run) of 2 x 2,048 each (``FAMILY_TRAIN_RUNS``): HuBERT-XLarge at all 48 layers
   through ``train()``, deepseek-V2-Lite (the dense prefix and 7 MoE
   layers) and Llama-3.2-Vision (2 periods, 2 cross layers) through
   ``train()``'s own step, pipeline and ``device_batch`` (:func:`cut_train`:
   ``train()`` has no depth argument), each loss falling, with the
   parameter count and the 12 bytes a parameter reckoned; (g)
   ``attn_remat`` on the card: Qwen2-0.5B one train step of batch 1 at
   S = 4,096, 8,192 and 16,384 with the flag on and off (the full run:
   4,096 alone; ``--train``: at 32,768 on too), peak memory and step ms
   (:func:`remat_sweep`); the loss and every
   gradient with the flag on bit-equal to the flag off at 2 x 2,048; on
   an f32 deepseek (the prefix and 2 MoE layers) the flag on within 2x the
   spread of two runs with the flag off (:func:`remat_checks`).  Every
   model trains with its config's ``attn_remat``.  ``python3 chip_smoke.py
   --train`` runs phases 2 and 23 alone.

24. ``sharded`` — the mesh layer (``launch/sharding.py``, the mesh paths
   of ``launch/steps.py``) on one-rank meshes: a real NCCL group of one
   rank (NCCL refuses two ranks on one card), every parameter, moment,
   batch and cache a DTensor laid out by the reference's specs, each
   kernel launched on its rank's local shards (``kernels/_sharded.py``).
   (a) RWKV-6 3B and RecurrentGemma-2B at full width and depth, 3 train
   steps of 2 x 2,048 each through ``make_train_step(cfg, mesh)`` on a
   1 x 1 mesh, against ``make_train_step(cfg)`` on the same weights and
   batches: loss, gnorm and every parameter leaf after every step; RWKV-6
   once more on a 1 x 1 x 1 pod mesh with ``grad_compress``, against the
   unsharded step followed by the int8 round trip; (b) Qwen2-0.5B with
   ``attention_impl="pallas"`` and ``pure_dp`` off (TP on the model
   axis): one scoring forward (``model_apply``, mode train, no grad:
   where ``flash_attention`` runs), a prefill of 8 x 512 and 8 decode
   steps through the mesh steps against the unsharded steps — logits,
   tokens and every cache tensor; (c) one dry-run cell
   (``qwen2_0_5b``, ``decode_32k``, 16 x 16 fake ranks) in a subprocess
   on the host, beside the other parts;
   (d) the dry run's step-peak tracker on real tensors: the first sharded
   train step of Qwen2-0.5B and of RWKV-6 3B (2 x 2,048) under
   ``dryrun.Recorder``, its peak of the step's temporaries within 2% of
   ``max_memory_allocated`` above the arguments.
   At one rank every DTensor op runs the local op of the unsharded path,
   so every comparison is bit for bit.  Each run's launches of the scans,
   their backwards and ``flash_attention`` equal its unsharded twin's,
   and are not zero; step ms sharded and unsharded (DTensor's host cost
   at D = 1).  ``python3 chip_smoke.py --sharded`` runs phases 2 and 24
   alone.

Then one JSON line with every kernel's numbers and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises (non-zero
exit); without a CUDA device, or without the repository's ``src/``, the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
C_MAX = 16                     # bench_pq.C_MAX (and bench_graph's)
N_KEYS = 4_000_000             # initial keys of the pq phases
THREADS = 8
OPS_PER_THREAD = 200           # pq phases (depth cut to fit the run)
REPLAY_BATCHES = 240
KERNEL_CASES = 24              # checked passes a heap shape, K = 1 and 4
GRAPH_VERTICES = 1_000_000     # graph, unionfind and label_prop checks
GRAPH_OPS = 300                # per thread, graph and unionfind phases
READ_PCT = 90                  # bench_graph / bench_unionfind c = 90
GRAPH_REPLAY = 200
UF_REPLAY = 120
MAP_KEYS = 1_000_000           # map and sketch phases (bench_map's _items)
MAP_KEY_RANGE = (0.0, 1000.0)  # bench_map.KEY_RANGE / bench_sketch's
MAP_OPS = 250                  # per thread, map and sketch phases
MAP_REPLAY = 150
SKETCH_REPLAY = 100
TOPK_MAX = 8
KEY_RANGE = 2 ** 31 - 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_EPS = float(np.finfo(np.float32).eps)
RANGE_SUM_EPS = 48             # range_sum limit in eps_f32 * P: ~3x the
                               # worst measured at 10^6 keys (16.7)
F32_OPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM, TF32 on the tensor cores, dense
REPLACES = {
    "heap_kmin": "src/repro/kernels/heap_kmin/kernel.py:86",
    "heap_sift": "src/repro/kernels/heap_sift/kernel.py:115",
    "heap_insert": "src/repro/kernels/heap_insert/kernel.py:170",
    "label_prop": "src/repro/kernels/label_prop/kernel.py:112",
    "sorted_merge": "src/repro/kernels/sorted_merge/kernel.py:107",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:135",
    "rwkv6_scan": "src/repro/kernels/linear_scan/kernel.py:116",
    "rglru_scan": "src/repro/kernels/linear_scan/kernel.py:188",
    # the backward kernels replace no TPU kernel (the reference's have no
    # backward): each names the forward TPU kernel whose gradient it is
    "rwkv6_scan_bwd": "src/repro/kernels/linear_scan/kernel.py:116",
    "rglru_scan_bwd": "src/repro/kernels/linear_scan/kernel.py:188",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}


def shard_capacity(n_keys: int, n_shards: int, c_max: int = C_MAX,
                   z: float = 6.0) -> int:
    """Per-shard capacity that survives hash-routing skew w.h.p. (a copy
    of ``benchmarks/bench_pq.py``'s rule: mean + z·σ of a binomial
    occupancy, plus one batch and the scratch slot)."""
    n = max(int(n_keys), 1)
    p = 1.0 / n_shards
    sigma = math.sqrt(n * p * (1.0 - p))
    return int(math.ceil(n * p + z * sigma)) + c_max + 2


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def count(dev, n: int):
    """A () int32 count on ``dev``: how the PQ's kernels take theirs."""
    import torch

    return torch.tensor(int(n), dtype=torch.int32, device=dev)


def pq_row(dev, ne: int, buf, ni: int, tag: int = 0):
    """One packed pass row (``batched_pq.pack_rows``) on ``dev``: the
    counts and the insert values in one host-to-device copy."""
    import torch

    from repro_torch.core import batched_pq as bpq

    return torch.from_numpy(bpq.pack_rows(
        [(tag, ne, np.asarray(buf, np.float32), ni)], C_MAX)[0]).to(dev)


# ---------------------------------------------------------------------------
# kernels: every launch held against the plain version on cloned inputs
# ---------------------------------------------------------------------------
class CheckedPhases:
    """A pass's three phases, each run by the kernel wrapper AND by the
    plain version on clones of the same inputs, compared element-wise
    (any difference raises).  The last inputs of each kernel are kept for
    timing."""

    def __init__(self):
        self.calls = {"heap_kmin": 0, "heap_sift": 0, "heap_insert": 0}
        self.max_abs_err = dict.fromkeys(self.calls, 0.0)
        self.inputs = {}
        self.wide = {}      # wide_cases' launches among the calls: widths

    def _diff(self, kernel, what, got, want):
        """Record the largest |kernel - plain| over the outputs checked so
        far (+inf equal to +inf counts 0), and raise unless equal."""
        import torch

        name = f"{kernel} {what}"
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: shape/dtype {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        g, w = got.double(), want.double()
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        err = torch.where(same, 0.0, (g - w).abs())
        err = float(torch.nan_to_num(err, nan=math.inf).max()) \
            if err.numel() else 0.0
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name}: kernel != plain, max_abs_err {err}, "
                f"{int((got != want).sum())} elements differ")

    def kmin(self, a, size, ne, *, c_max):
        import torch

        from repro_torch.kernels import heap_kmin

        if not isinstance(ne, torch.Tensor):      # the checks' own counts
            ne = count(a.device, ne)
        self.inputs["heap_kmin"] = (a.clone(), size.clone(), ne.clone(),
                                    c_max)
        ids, vals = heap_kmin.k_smallest_sharded(a, size, ne, c_max=c_max)
        pids, pvals = heap_kmin.k_smallest_plain(a, size, ne, c_max)
        self._diff("heap_kmin", "ids", ids, pids)
        self._diff("heap_kmin", "vals", vals, pvals)
        self.calls["heap_kmin"] += 1
        return ids, vals

    def sift(self, a, size, starts, active):
        from repro_torch.kernels import heap_sift

        self.inputs["heap_sift"] = (a.clone(), size.clone(), starts.clone(),
                                    active.clone())
        ap = a.clone()
        heap_sift.sift_wavefront_sharded(a, size, starts, active)
        heap_sift.sift_wavefront_plain(ap, size, starts, active)
        self._diff("heap_sift", "heap", a, ap)
        self.calls["heap_sift"] += 1
        return a

    def phase4(self, a, size, rem, m_left):
        from repro_torch.kernels import heap_insert

        self.inputs["heap_insert"] = (a.clone(), size.clone(), rem.clone(),
                                      m_left.clone())
        ap = a.clone()
        _, new_size = heap_insert.phase4_sharded(a, size, rem, m_left)
        _, psize = heap_insert.phase4_plain(ap, size, rem, m_left)
        self._diff("heap_insert", "heap", a, ap)
        self._diff("heap_insert", "size", new_size, psize.to(new_size.dtype))
        self.calls["heap_insert"] += 1
        return a, new_size


def random_heap_stack(torch, K, cap, sizes, gen, dup, dev):
    """A valid random heap per shard: a[v] = a[v // 2] + increment, level by
    level (duplicates when the increments are coarse), +inf past size."""
    a = torch.empty((K, cap), dtype=torch.float32, device=dev)
    a[:, 0] = math.inf
    a[:, 1] = torch.floor(torch.rand(K, generator=gen, device=dev) * 1e6)
    lo = 2
    while lo < cap:
        hi = min(2 * lo, cap)
        inc = torch.rand((K, hi - lo), generator=gen, device=dev) * 1e5
        inc = torch.floor(inc / 5e4) * 5e4 if dup else torch.floor(inc)
        par = torch.arange(lo, hi, device=dev) // 2
        a[:, lo:hi] = a[:, par] + inc
        lo = hi
    idx = torch.arange(cap, device=dev)
    size_t = torch.tensor(sizes, dtype=torch.int32, device=dev)
    a[idx[None, :] > size_t[:, None]] = math.inf
    a[:, 0] = math.inf
    return a, size_t


def pick_sizes(rng, K, cap, c_max):
    top = cap - 1 - c_max
    out = []
    for _ in range(K):
        kind = int(rng.integers(5))
        if kind == 0:
            out.append(0)                                  # empty heap
        elif kind == 1:
            out.append(int(rng.integers(1, c_max)))        # ne > size
        elif kind == 2:                                    # level boundary
            d = int(rng.integers(2, int(math.log2(top))))
            out.append(max((1 << d) - 1 - int(rng.integers(0, c_max)), 0))
        else:
            out.append(int(rng.integers(top // 2, top)))
    return out


INSERT_WIDTHS = (1, 32, 33, 64)   # heap_insert: one and two values a lane
SIFT_WIDTHS = (33, 64, 1024)      # heap_sift: two warps to heap_sift.MAX_C
KMIN_WIDTHS = (33, 64)            # heap_kmin: past C_MAX to heap_kmin.MAX_C
NEAR_EMPTY = (0, 1, 2, 3, 6, 7)   # sizes whose batches take several chunks


def deep_path_heap(torch, K, cap, sizes, rng, dev):
    """A heap per shard whose smallest keys run down one random root-to-leaf
    path (0, 1, 2, ... by depth) and every other node sits above 1e6,
    rising by level: the frontier search's worst case for cache misses."""
    v = np.arange(cap)
    depth = np.floor(np.log2(np.maximum(v, 1))).astype(np.int64)
    a = np.empty((K, cap), np.float32)
    for k in range(K):
        a[k] = 1e6 + depth * 1e3 + np.floor(rng.random(cap) * 999)
        node = 1
        while node <= min(sizes[k], cap - 1):
            a[k, node] = depth[node]
            node = 2 * node + int(rng.integers(2))
    a[v[None, :] > np.array(sizes)[:, None]] = np.inf
    a[:, 0] = np.inf
    return (torch.from_numpy(a).to(dev),
            torch.tensor(sizes, dtype=torch.int32, device=dev))


def kmin_cases(torch, dev, rng, gen, cap, checked, K=4):
    """``heap_kmin`` past the pass's widths, each launch held to the plain
    version by ``checked``: c_max 33 and 64 (ne = c_max and ne = c_max / 2)
    on random heaps with duplicates, the deep-path heap (the smallest keys
    down one path) at C_MAX and 64, and a heap whose top three levels are
    -0.0 and +0.0 in turn (ties across frontier slots).  Returns the
    widths of the launches made."""
    done = []
    for c in KMIN_WIDTHS:
        a, size = random_heap_stack(torch, K, cap,
                                    pick_sizes(rng, K, cap, c), gen,
                                    dup=True, dev=dev)
        for ne in (c, c // 2):
            checked.kmin(a, size, ne, c_max=c)
            done.append(c)
    sizes = [cap - 1 - int(rng.integers(0, 1000)) for _ in range(K)]
    sizes[0] = 100                       # the path ends inside the heap
    a, size = deep_path_heap(torch, K, cap, sizes, rng, dev)
    for c in (C_MAX, 64):
        checked.kmin(a, size, c, c_max=c)
        done.append(c)
    a, size = random_heap_stack(torch, K, cap, pick_sizes(rng, K, cap, 64),
                                gen, dup=True, dev=dev)
    signs = torch.tensor([-0.0, 0.0, -0.0, 0.0, 0.0, -0.0, 0.0],
                         device=dev)
    top = torch.arange(1, 8, device=dev)
    a[:, 1:8] = torch.where(top[None, :] <= size[:, None], signs, a[:, 1:8])
    for c in (C_MAX, 64):
        checked.kmin(a, size, c, c_max=c)
        done.append(c)
    return done


def wide_cases(torch, dev, rng, gen, cap, checked, K=4):
    """Widths past the pass's C_MAX, each launch held bit-equal to the
    plain version by ``checked``: ``heap_insert`` at every width of
    INSERT_WIDTHS on K shards of ``cap`` slots -- near-empty heaps (a
    batch of C takes several level-chunks), heaps one batch short of a
    level's end and large ones, m_left from 0 to C with duplicates --, and
    ``heap_sift`` with SIFT_WIDTHS cursors on real frontiers (the plain
    phase 1 and 2 at c_max = c, ``ne`` = c).  Returns the widths of the
    launches made, by kernel."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.kernels import heap_kmin

    done = {"heap_insert": [], "heap_sift": []}
    for C in INSERT_WIDTHS:
        for case in range(3):
            if case == 0:
                sizes = [int(rng.choice(NEAR_EMPTY)) for _ in range(K)]
            else:
                sizes = pick_sizes(rng, K, cap, max(C, 2))
            a, size = random_heap_stack(torch, K, cap, sizes, gen,
                                        dup=case == 1, dev=dev)
            m = [C if case == 0 else int(rng.integers(0, C + 1))
                 for _ in range(K)]
            m[-1] = C
            vals = np.floor(rng.uniform(0, 2e6, (K, C))).astype(np.float32)
            vals[:, ::3] = vals[:, :1]                       # duplicates
            vals[np.arange(C)[None, :] >= np.array(m)[:, None]] = np.inf
            rem = torch.tensor(np.sort(vals, axis=1), device=dev)
            checked.phase4(a, size, rem,
                           torch.tensor(m, dtype=torch.int32, device=dev))
            done["heap_insert"].append(C)
    for c in SIFT_WIDTHS:
        top = cap - 1 - c
        if top < 4 * c:              # the host rehearsal's small heaps
            continue
        sizes = [top - int(rng.integers(0, 1000)) for _ in range(K)]
        a, size = random_heap_stack(torch, K, cap, sizes, gen, dup=True,
                                    dev=dev)
        ni = int(rng.integers(0, c // 2))
        vals = torch.full((K, c), math.inf, device=dev)
        vals[:, :ni] = torch.floor(torch.rand((K, ni), generator=gen,
                                              device=dev) * 2e6)
        phase1 = heap_kmin.k_smallest_plain(a, size, count(dev, c), c)
        lanes = torch.full((K,), c, dtype=torch.int32, device=dev)
        a2, size2, _, _, starts, active, _, _ = bpq._phases12(
            a, size, lanes, vals, torch.full_like(lanes, ni), c_max=c,
            phase1=phase1, n_pull=c)
        checked.sift(a2, size2, starts, active)
        done["heap_sift"].append(c)
    return done


def kernel_phase(torch, dev, seed, caps, n_cases):
    """Random heaps and batches through checked passes, K = 1 and K = 4,
    then :func:`wide_cases` at the K = 4 shape."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq

    checked = CheckedPhases()
    phases = bpq.Phases(checked.kmin, checked.sift, checked.phase4)
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for K, cap in caps:
        for case in range(n_cases):
            sizes = pick_sizes(rng, K, cap, C_MAX)
            a, size = random_heap_stack(torch, K, cap, sizes, gen,
                                        dup=case % 2 == 1, dev=dev)
            kind = case % 4       # extract-only, insert-only, mixed, full
            ne = 0 if kind == 1 else int(rng.integers(1, C_MAX + 1))
            ni = 0 if kind == 0 else int(rng.integers(1, C_MAX + 1))
            if kind == 3:
                ne = ni = C_MAX
            buf = np.full(C_MAX, np.inf, np.float32)
            root = float(a[:, 1].min()) if max(sizes) else 0.0
            fresh = rng.uniform(0, 2e6, ni).astype(np.float32)
            dups = np.float32(root if math.isfinite(root) else 0.0)
            buf[:ni] = np.where(rng.random(ni) < 0.3, dups, np.floor(fresh))
            row = pq_row(dev, ne, buf, ni)
            if K == 1:
                st = bpq.HeapState(a[0], size[0])
                bpq.apply_batch_impl(st, row, c_max=C_MAX,
                                     n_pull=max(ne - ni, 0), phases=phases)
            else:
                st = spq.ShardedHeapState(a, size)
                spq._sharded_apply_batch(st, row, c_max=C_MAX, n_shards=K,
                                         n_pull=ne, phases=phases)
    K, cap = caps[-1]
    checked.wide = wide_cases(torch, dev, rng, gen, cap, checked, K)
    checked.wide["heap_kmin"] = kmin_cases(torch, dev, rng, gen, cap,
                                           checked, K)
    # dedicated batches at the K = 4 shape for timing: extract-only keeps
    # heap_kmin and heap_sift inputs, insert-only the heap_insert inputs
    sizes = [cap - 1 - C_MAX - int(rng.integers(0, 1000)) for _ in range(K)]
    a, size = random_heap_stack(torch, K, cap, sizes, gen, dup=False,
                                dev=dev)
    st = spq.ShardedHeapState(a, size)
    spq._sharded_apply_batch(st, pq_row(dev, C_MAX, np.full(C_MAX, np.inf),
                                        0),
                             c_max=C_MAX, n_shards=K, phases=phases)
    timed = {"heap_kmin": checked.inputs["heap_kmin"],
             "heap_sift": checked.inputs["heap_sift"]}
    ins = np.floor(rng.uniform(0, 2e6, C_MAX))
    spq._sharded_apply_batch(st, pq_row(dev, 0, ins, C_MAX), c_max=C_MAX,
                             n_shards=K, phases=phases)
    timed["heap_insert"] = checked.inputs["heap_insert"]
    for name, n in checked.calls.items():
        check(n > 0, f"{name}: never checked")
    return checked, timed


RING = 30                 # launches per timed window, one heap copy each
PLAIN_RING = 10           # the plain versions take milliseconds per call
WINDOWS = 5
HOLD_CYCLES = 100_000_000  # torch.cuda._sleep: ~50 ms at the H100's clock


def _per_launch_ms(torch, fn, ring, a_in, hold, windows=WINDOWS):
    """Median over ``windows`` of one CUDA-event window around
    ``len(ring)`` back-to-back calls ``fn(ring[i])``, divided by the count.
    Every call gets its own copy of the heap ``a_in`` (restored before the
    window, outside it), so no in-place call sees its predecessor's output.
    With ``hold``, a spin kernel keeps the stream busy while the host
    enqueues the calls, so the window holds the device's time and no host
    gaps; a window that the device caught up with raises.  Without it (the
    plain versions, which synchronise inside, and ``torch.topk``, which
    may) the window is their wall time."""
    times = []
    for w in range(windows + 1):              # window 0 warms up
        for r in ring:
            r.copy_(a_in)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        t0.record()
        for r in ring:
            fn(r)
        caught_up = hold and t0.query()
        t1.record()
        t1.synchronize()
        if w:
            check(not caught_up, "timing: the device caught up with the "
                                 "host inside a held window")
            times.append(t0.elapsed_time(t1) / len(ring))
    return float(np.median(times))


def pq_capacities(n_keys, threads, ops, n_replay):
    """The per-shard capacities of the pq phases, K = 1 and K = 4."""
    total = n_keys + threads * ops + n_replay * C_MAX + 2
    return shard_capacity(total, 1), shard_capacity(total, 4)


def heap_phase(torch, dev, seed, cap1, cap4, n_cases, timing, out=print):
    """Phase 3: :func:`kernel_phase` (with :func:`wide_cases`), then with
    ``timing`` :func:`time_kernels`; prints one line a heap kernel.
    Returns (the checks, the times)."""
    t0 = time.perf_counter()
    checked, timed = kernel_phase(torch, dev, seed, [(1, cap1), (4, cap4)],
                                  n_cases)
    times = time_kernels(torch, timed) if timing else {}
    for name in ("heap_kmin", "heap_sift", "heap_insert"):
        t = times.get(name, {})
        w = checked.wide.get(name)
        wide = (f", {len(w)} of them at widths {sorted(set(w))}" if w
                else "")
        out(f"kernels: {name} == plain on {checked.calls[name]} launches"
            f"{wide} (max_abs_err {checked.max_abs_err[name]}; heap kernels "
            f"{time.perf_counter() - t0:.1f} s); "
            + ("timing not measured" if not t else
               f"ms {t['ms']:.6f} plain_ms {t['plain_ms']:.6f} "
               f"bound_ms {t['bound_ms']:.3e} ({t['bound_by']}) "
               f"library_ms {t['library_ms']}"))
    return checked, times


def time_kernels(torch, timed):
    """Per-launch times (CUDA events over back-to-back launches, see
    :func:`_per_launch_ms`) of each kernel, its plain version and, for
    heap_kmin, torch.topk — on the kept K = 4 inputs; the bound from the
    bytes and operations these inputs need."""
    from repro_torch.kernels import heap_insert, heap_kmin, heap_sift

    def rings(a_in):
        return ([torch.empty_like(a_in) for _ in range(RING)],
                [torch.empty_like(a_in) for _ in range(PLAIN_RING)])

    out = {}
    a_in, size, ne, c_max = timed["heap_kmin"]
    ids, _ = heap_kmin.k_smallest_sharded(a_in, size, ne, c_max=c_max)
    K = a_in.shape[0]
    steps = int((ids > 0).sum())
    ring, plain_ring = rings(a_in)
    out["heap_kmin"] = dict(
        ms=_per_launch_ms(torch, lambda a: heap_kmin.k_smallest_sharded(
            a, size, ne, c_max=c_max), ring, a_in, hold=True),
        plain_ms=_per_launch_ms(torch, lambda a: heap_kmin.k_smallest_plain(
            a, size, ne, c_max), plain_ring, a_in, hold=False),
        library_ms=_per_launch_ms(torch, lambda a: torch.topk(
            a, int(ne), dim=1, largest=False), ring, a_in, hold=False),
        bytes=4 * (K + 2 * steps) + 4 * K + 8 * K * c_max,
        ops=steps * (2 * c_max + 1))

    a_in, size, starts, active = timed["heap_sift"]
    a = a_in.clone()
    heap_sift.sift_wavefront_sharded(a, size, starts, active)
    changed = int((a != a_in).sum())
    c = starts.shape[1]
    ring, plain_ring = rings(a_in)
    out["heap_sift"] = dict(
        ms=_per_launch_ms(torch, lambda a: heap_sift.sift_wavefront_sharded(
            a, size, starts, active), ring, a_in, hold=True),
        plain_ms=_per_launch_ms(torch, lambda a: heap_sift.sift_wavefront_plain(
            a, size, starts, active), plain_ring, a_in, hold=False),
        library_ms=None,
        bytes=8 * changed + 4 * K + 5 * K * c, ops=3 * changed)

    a_in, size, rem, m_left = timed["heap_insert"]
    a = a_in.clone()
    heap_insert.phase4_sharded(a, size, rem, m_left)
    changed = int((a != a_in).sum())
    C = rem.shape[1]
    levels = int(math.log2(a.shape[1])) + 1
    ring, plain_ring = rings(a_in)
    out["heap_insert"] = dict(
        ms=_per_launch_ms(torch, lambda a: heap_insert.phase4_sharded(
            a, size, rem, m_left), ring, a_in, hold=True),
        plain_ms=_per_launch_ms(torch, lambda a: heap_insert.phase4_plain(
            a, size, rem, m_left), plain_ring, a_in, hold=False),
        library_ms=None,
        bytes=8 * changed + 4 * K * C + 12 * K,
        ops=int(m_left.sum()) * levels * C)
    del ring, plain_ring
    for r in out.values():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = r["ops"] / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(byte_ms, op_ms)
        r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    return out


# ---------------------------------------------------------------------------
# the main path: the concurrent PQ under 8 client threads, then a replay
# ---------------------------------------------------------------------------
def drive(engine, threads, ops, seed):
    """``threads`` clients, each a 50/50 insert/extract_min stream."""
    inserted = [[] for _ in range(threads)]
    extracted = [[] for _ in range(threads)]
    errors = []

    def client(tid):
        try:
            r = np.random.default_rng([seed, 2, tid])
            vals = r.uniform(0, KEY_RANGE, ops).astype(np.float32)
            for i in range(ops):
                if r.integers(2) == 0:
                    engine.execute("insert", float(vals[i]))
                    inserted[tid].append(vals[i])
                else:
                    extracted[tid].append(engine.execute("extract_min"))
        except BaseException as exc:       # re-raised on the main thread
            errors.append(exc)

    ts = [threading.Thread(target=client, args=(t,), daemon=True)
          for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "client threads hung")
    if errors:
        raise errors[0]
    ins = np.array([v for lst in inserted for v in lst], np.float32)
    ext = [v for lst in extracted for v in lst]
    return ins, ext, seconds


def replay(torch, pq, pass_fn, plain_phases, n_batches, seed):
    """Seeded single-thread batches through the kernel pass and the plain
    pass on clones of the queue's state, bit-equal after every batch, and
    answers equal to SequentialHeap's."""
    from repro_torch.core.seq_pq import SequentialHeap

    rng = np.random.default_rng([seed, 3])
    st_k = type(pq.state)(pq.state.a.clone(), pq.state.size.clone())
    st_p = type(pq.state)(pq.state.a.clone(), pq.state.size.clone())
    oracle = SequentialHeap()
    oracle.a = [float("-inf")] + pq.values()
    dev = pq.state.a.device
    for b in range(n_batches):
        w = int(rng.integers(1, C_MAX + 1))
        kind = b % 3            # extract-heavy, insert-heavy, mixed
        ne = w if kind == 0 else (int(rng.integers(0, w // 4 + 1))
                                  if kind == 1 else int(rng.integers(0, w + 1)))
        ni = w if kind == 1 else (int(rng.integers(0, w // 4 + 1))
                                  if kind == 0 else int(rng.integers(0, w + 1)))
        head = oracle.a[1] if oracle.size else 0.0
        fresh = rng.uniform(0, KEY_RANGE, ni).astype(np.float32)
        ins = np.where(rng.random(ni) < 0.25, np.float32(head), fresh)
        buf = np.full(C_MAX, np.inf, np.float32)
        buf[:ni] = ins
        _, out_k, _ = pass_fn(st_k, ne, buf, ni)
        _, out_p, _ = pass_fn(st_p, ne, buf, ni, phases=plain_phases)
        check(torch.equal(st_k.a, st_p.a) and torch.equal(st_k.size,
                                                          st_p.size)
              and torch.equal(out_k, out_p),
              f"replay batch {b}: kernel pass != plain pass")
        want = [oracle.extract_min() for _ in range(ne)]
        for v in ins:
            oracle.insert(float(v))
        got = out_k[:ne].cpu().numpy().tolist()
        got = [g if math.isfinite(g) else None for g in got]
        check(got == want, f"replay batch {b}: {got} != oracle {want}")
    check(sorted(oracle.a[1:]) == sorted(
        _values(st_k.a.cpu().numpy(), st_k.size.cpu().numpy())),
        "replay: final multiset differs from the oracle")
    return n_batches


def _values(a, sizes):
    a = a.reshape(-1, a.shape[-1])
    sizes = np.asarray(sizes).reshape(-1)
    return [v for k in range(a.shape[0])
            for v in a[k, 1:int(sizes[k]) + 1].tolist()]


def counted(torch, dev, name, counters, expect, fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just before
    and read just after; on the card, each kernel in ``expect`` must have
    launched.  Returns ``(fn's result, counts)``."""
    for f in counters.values():
        f.launches = 0
    got = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    if dev.type == "cuda":
        for k in expect:
            check(launches[k] > 0, f"{name}: kernel {k} was never launched "
                                   f"on the main path")
    return got, launches


def pq_phase(torch, name, engine, init, counters, seed, threads, ops,
             n_replay, pass_fn, plain_phases):
    from repro_torch.core.batched_pq import check_heap_property

    pq = engine.pq
    (ins, ext, seconds), launches = counted(
        torch, pq.state.a.device, name, counters,
        ("heap_kmin", "heap_sift", "heap_insert"),
        lambda: drive(engine, threads, ops, seed))
    # conservation: initial ∪ inserted == extracted ∪ remaining
    check(all(v is not None for v in ext), f"{name}: empty-queue extract")
    remaining = np.array(pq.values(), np.float32)
    lhs = np.sort(np.concatenate([init, ins]))
    rhs = np.sort(np.concatenate([np.array(ext, np.float32), remaining]))
    check(np.array_equal(lhs, rhs), f"{name}: multiset not conserved")
    a = pq.state.a.cpu().numpy().reshape(-1, pq.state.a.shape[-1])
    sizes = pq.state.size.cpu().numpy().reshape(-1)
    for k in range(a.shape[0]):
        check(np.isinf(a[k, 0]), f"{name}: shard {k} scratch slot not +inf")
        check(check_heap_property(a[k], int(sizes[k])),
              f"{name}: shard {k} violates the heap property")
    n_ops = threads * ops
    stats = {
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "eliminated": engine.eliminated,
        "launches": launches,
        "heap_bytes": pq.state.a.numel() * 4 + pq.state.size.numel() * 4,
    }
    stats["replayed"] = replay(torch, pq, pass_fn, plain_phases, n_replay,
                               seed)
    return stats


# ---------------------------------------------------------------------------
# megapass: the PQ's rounds as one CUDA-graph replay a dispatch
# ---------------------------------------------------------------------------
MEGA_LISTS = 40                # seeded round lists, replay == eager == plain
MEGA_SMALL = 8                 # of them on a near-empty heap
MEGA_MAX_ROWS = 32
MEGA_TIMED_ROWS = (1, 4, 8, 16)
MEGA_REPS = 10                 # dispatches timed a row count (median)
MEGA_MIX = (0.45, 0.45, 0.10)  # insert, extract_min, peek_min


def _bits_list(xs):
    """A round's answers as f32 bit patterns, None kept."""
    return [None if x is None else int(np.float32(x).view(np.int32))
            for x in xs]


def _clone_heap(st):
    return type(st)(st.a.clone(), st.size.clone())


def _heap_bits_equal(torch, x, y):
    return (torch.equal(x.a.view(torch.int32), y.a.view(torch.int32))
            and torch.equal(x.size, y.size))


def mega_rounds(rng, pq, max_rows):
    """A seeded round list of at most ``max_rows`` rows: update rounds of
    1 to 3 x C_MAX ops (fresh keys, repeats of the list's own keys, ties
    at small keys, -0.0 and subnormals; extracts past a small shard's
    size), ``peek_min`` rounds of 1 to 3 ops, and empty rounds."""
    target = int(rng.integers(1, max_rows + 1))
    rounds, seen = [], [1.0]
    ties = np.array([0.0, -0.0, 1e-40, -1e-42, 1.0, 2.0], np.float32)
    for _ in range(4 * max_rows):
        u = rng.random()
        if u < 0.6:
            n = int(rng.integers(1, 3 * C_MAX + 1))
            ext = rng.random(n) < rng.uniform(0.2, 0.8)
            keys = []
            for _ in range(n):
                v = rng.random()
                keys.append(float(rng.choice(seen)) if v < 0.25 else
                            float(rng.choice(ties)) if v < 0.4 else
                            float(np.floor(rng.uniform(0, KEY_RANGE))))
            seen.extend(keys)
            r = ("update", ["extract_min" if e else "insert" for e in ext],
                 [None if e else k for e, k in zip(ext, keys)])
        elif u < 0.9:
            n = int(rng.integers(1, 4))
            r = ("read", ["peek_min"] * n, [None] * n)
        else:
            r = (("update", "read")[int(rng.integers(2))], [], [])
        if len(pq._mixed_specs(rounds + [r])[0]) > target:
            break
        rounds.append(r)
    return rounds


def mega_three_ways(torch, pq, lists, consume_reversed):
    """Dispatch ``lists`` (one or two round lists, back to back) through
    the instance (a graph replay on the card), and their padded rows
    through ``_sharded_mixed_rows`` on two clones of the heap taken before:
    the eager kernel pass and the plain pass.  Heaps, outs (of a single
    dispatch) and every handle's answers must be bit-equal."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq

    st_e, st_p = _clone_heap(pq.state), _clone_heap(pq.state)
    dispatched = []
    for rounds in lists:
        specs, plans = pq._mixed_specs(rounds)
        hs = pq.mixed_rounds(rounds)
        g_outs = None
        if specs and pq.device.type == "cuda":
            g_outs = pq._graphs[len(spq.pad_rows(specs, C_MAX))].outs.clone()
        dispatched.append((specs, plans, hs, g_outs))
    order = (range(len(lists) - 1, -1, -1) if consume_reversed
             else range(len(lists)))
    got = {i: [h.result() for h in (dispatched[i][2][::-1]
                                     if consume_reversed
                                     else dispatched[i][2])]
           for i in order}
    n_rows = 0
    for i, (specs, plans, hs, g_outs) in enumerate(dispatched):
        if consume_reversed:
            got[i] = got[i][::-1]
        if not specs:
            check(all(r == [] or r == [None] * len(r) for r in got[i]),
                  "megapass: an empty dispatch answered")
            continue
        padded = spq.pad_rows(specs, C_MAX)
        n_rows = max(n_rows, len(padded))
        rows = torch.from_numpy(bpq.pack_rows(padded, C_MAX)).to(
            pq.device)
        outs_e, k_e = spq._sharded_mixed_rows(st_e, rows, **pq._pass_kw)
        outs_p, k_p = spq._sharded_mixed_rows(
            st_p, rows, phases=bpq.PLAIN_PHASES, **pq._pass_kw)
        check(torch.equal(outs_e.view(torch.int32),
                          outs_p.view(torch.int32))
              and torch.equal(k_e, k_p), "megapass: eager outs != plain")
        if g_outs is not None and len(lists) == 1:
            check(torch.equal(g_outs.view(torch.int32),
                              outs_e.view(torch.int32)),
                  "megapass: replay outs != eager outs")
        for outs in (outs_e, outs_p):
            want = [h.result() for h in pq._mixed_handles(
                plans, bpq._RoundsFetch(outs))]
            check([_bits_list(r) for r in got[i]]
                  == [_bits_list(r) for r in want],
                  f"megapass: handles' answers {got[i]} != {want}")
    check(_heap_bits_equal(torch, pq.state, st_e)
          and _heap_bits_equal(torch, st_e, st_p),
          "megapass: heap after the replay != eager != plain")
    return n_rows


def mega_lists(torch, dev, seed, pq, small, n_lists=MEGA_LISTS):
    """Part a: ``n_lists`` seeded round lists, MEGA_SMALL of them on the
    near-empty ``small`` heap; every fifth dispatched back to back with
    the next and both consumed in reverse.  Returns the lists checked, the
    row counts met and ``memory_reserved`` before and after."""
    rng = np.random.default_rng([seed, 30])
    reserved0 = torch.cuda.memory_reserved() if dev.type == "cuda" else 0
    rows, i, checked = [], 0, 0
    while i < n_lists:
        q = small if i < MEGA_SMALL else pq
        pair = i % 5 == 4 and i + 1 < n_lists and i + 1 != MEGA_SMALL
        lists = [mega_rounds(rng, q, MEGA_MAX_ROWS if q is pq else 8)
                 for _ in range(2 if pair else 1)]
        rows.append(mega_three_ways(torch, q, lists, consume_reversed=pair))
        checked += len(lists)
        i += len(lists)
    reserved1 = torch.cuda.memory_reserved() if dev.type == "cuda" else 0
    return {"lists": checked, "rows": sorted(set(rows)),
            "reserved_before": reserved0, "reserved_after": reserved1}


def mega_contract(torch, pq, counters, seed):
    """Part b: one ``mixed_rounds`` of an already-captured row count plus
    the consumption of all its handles makes exactly one blocking fetch
    and no other sync (``one_fetch``); ``graph_replays`` rises by one, and
    each heap kernel's count by the launches its graph captured."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq

    rng = np.random.default_rng([seed, 31])
    rounds = mega_rounds(rng, pq, 8)
    while not pq._mixed_specs(rounds)[0]:
        rounds = mega_rounds(rng, pq, 8)
    [h.result() for h in pq.mixed_rounds(rounds)]      # captured by now
    n_rows = len(spq.pad_rows(pq._mixed_specs(rounds)[0], C_MAX))
    captured = {name: n for fn, n in pq._graphs[n_rows].launches
                for name, f in counters.items() if f is fn}
    replays0, launches0 = pq.graph_replays, _snap(counters)
    one_fetch(torch, bpq, lambda: [h.result()
                                   for h in pq.mixed_rounds(rounds)])
    delta = _launch_delta(counters, launches0)
    check(pq.graph_replays == replays0 + 1,
          f"megapass: {pq.graph_replays - replays0} replays a dispatch")
    check(all(delta[k] == captured[k] == n_rows for k in HEAP),
          f"megapass: launches {delta} != captured {captured} "
          f"({n_rows} rows)")
    return {"rows": n_rows, "captured": captured}


def mega_engine(torch, dev, seed, init, cap, counters, threads, ops,
                use_megapass):
    """Part c: ``pc_megapass_priority_queue`` over ``init`` under
    ``threads`` clients of MEGA_MIX; every dispatch's rounds and answers
    recorded, then replayed through ``SequentialBatchedPQ``: each answer
    must pass ``spec.result_ok`` and the final multisets be equal."""
    from repro_torch.core import substrate
    from repro_torch.core.pc_pq import pc_megapass_priority_queue
    from repro_torch.core.sharded_pq import SequentialBatchedPQ

    spec = substrate.get("pq")
    t0 = time.perf_counter()
    eng = pc_megapass_priority_queue(cap, C_MAX, n_shards=4, values=init,
                                     use_megapass=use_megapass, device=dev)
    setup_s = time.perf_counter() - t0
    log, real = [], eng._dispatch

    def recording(rounds, futs):
        real(rounds, futs)
        log.append((rounds, [[f.result() for f in fs] for fs in futs]))

    eng._dispatch = recording

    def draw(r):
        u = r.random()
        if u < MEGA_MIX[0]:
            return "insert", float(np.floor(r.uniform(0, KEY_RANGE)))
        return ("extract_min" if u < MEGA_MIX[0] + MEGA_MIX[1]
                else "peek_min"), None

    name = "megapass" if use_megapass else "megapass alternating"
    try:
        (_, seconds), launches = counted(
            torch, dev, name, counters, HEAP,
            lambda: drive_mixed(eng, threads, ops, seed, draw))
    finally:
        eng.close()
    t0 = time.perf_counter()
    oracle = SequentialBatchedPQ(init, c_max=C_MAX)
    for rounds, answers in log:
        for (kind, methods, inputs), got in zip(rounds, answers):
            want = (oracle.update_batch(methods, inputs) if kind == "update"
                    else oracle.read_batch(methods, inputs))
            check(all(spec.result_ok(m, g, w)
                      for m, g, w in zip(methods, got, want)),
                  f"{name}: answers {got} != the oracle's {want}")
    check(np.array_equal(np.asarray(eng.ds.values(), np.float32),
                         np.asarray(oracle.values(), np.float32)),
          f"{name}: final multiset differs from the oracle's")
    n = threads * ops
    return {"ops": n, "seconds": seconds, "ops_per_s": n / seconds,
            "dispatches": eng.megapass_dispatches,
            "rounds": eng.megapass_rounds,
            "rounds_per_dispatch": eng.rounds_per_dispatch,
            "graph_captures": eng.ds.graph_captures,
            "graph_replays": eng.ds.graph_replays,
            "launches": launches, "setup_s": setup_s,
            "replay_s": time.perf_counter() - t0}


def mega_timing(torch, pq, seed):
    """Part d: at R = MEGA_TIMED_ROWS update rows (8 extracts and 8 fresh
    inserts each), the capture's one-time ms (warm-up included), then
    MEGA_REPS dispatches through ``apply_rounds_async`` (one replay each)
    and as many eager ``_sharded_mixed_rows`` loops on a clone of the
    heap: host ms (the call, no sync) and device ms (CUDA events around
    it), medians.  Nothing here is claimed: the numbers go to PERF.md."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq

    rng = np.random.default_rng([seed, 32])
    out = {}
    for R in MEGA_TIMED_ROWS:
        def rounds():
            return [(8, np.floor(rng.uniform(0, KEY_RANGE, 8)).tolist())
                    for _ in range(R)]
        pq._graphs.pop(R, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pq._graphs[R] = pq._capture(R)
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        rec = {"replay": ([], []), "eager": ([], [])}
        clone = _clone_heap(pq.state)
        for rep in range(MEGA_REPS + 1):
            for kind in ("replay", "eager"):
                rs = rounds()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                t0 = time.perf_counter()
                if kind == "replay":
                    hs = pq.apply_rounds_async(rs)
                else:
                    specs, _ = bpq.expand_rounds(rs, C_MAX)
                    rows = torch.from_numpy(bpq.pack_rows(
                        [(spq.MEGA_UPDATE,) + s for s in specs],
                        C_MAX)).to(pq.device, non_blocking=True)
                    spq._sharded_mixed_rows(clone, rows, **pq._pass_kw)
                host = (time.perf_counter() - t0) * 1e3
                e1.record()
                e1.synchronize()
                if kind == "replay":
                    hs[0].result()            # re-tightens the mirror
                if rep:                       # the first is a warm-up
                    rec[kind][0].append(host)
                    rec[kind][1].append(e0.elapsed_time(e1))
        out[R] = {"capture_ms": capture_ms,
                  **{f"{k}_{w}_ms": float(np.median(v[j]))
                     for k, v in rec.items()
                     for j, w in enumerate(("host", "device"))}}
    return out


def c4_checks(torch, dev, seed, pq):
    """Part e: ``heap_kmin`` captured once and replayed with ne = 1, 5 and
    16 written into its device scalar, each equal to the plain version;
    one ``sorted_merge`` captured and replayed twice on new inputs copied
    into its static inputs, bit-equal to the plain version both times;
    then the epoch field spent on the card (word 0 of the stream's
    scratch set to its last epoch but one): the wrap call is right,
    leaves the word and every status word 0, and the next call is right
    at epoch 1."""
    from repro_torch.kernels import heap_kmin
    from repro_torch.kernels.sorted_merge import ops as merge_ops

    out = {}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    a, size = pq.state.a.clone(), pq.state.size.clone()
    ne = count(dev, 0)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        heap_kmin.k_smallest_sharded(a, size, ne, c_max=C_MAX)
        g.capture_begin(capture_error_mode="thread_local")
        ids, vals = heap_kmin.k_smallest_sharded(a, size, ne, c_max=C_MAX)
        g.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    for n in (1, 5, 16):
        ne.fill_(n)
        g.replay()
        pids, pvals = heap_kmin.k_smallest_plain(a, size, ne, C_MAX)
        check(torch.equal(ids, pids) and torch.equal(
            vals.view(torch.int32), pvals.view(torch.int32))
            and int((ids > 0).sum(1).max()) == n,
            f"c4: replayed heap_kmin at ne = {n} != plain")
    out["kmin_ne"] = [1, 5, 16]

    rng = np.random.default_rng([seed, 33])
    n_map = shard_capacity(MAP_KEYS, 4)

    def inputs():
        return merge_inputs(torch, dev, rng, 4, n_map, C_MAX, "few", C_MAX,
                            fill=MAP_KEYS // 4)

    def plain(inp):
        return merge_ops.merge_compact_plain(*inp)

    static = inputs()
    g = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        merge_ops.merge_compact_sharded(*static)
        g.capture_begin(capture_error_mode="thread_local")
        mk, mv = merge_ops.merge_compact_sharded(*static)
        g.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    for i in range(2):
        new = inputs()
        for t, x in zip(static, new):
            t.copy_(x)
        g.replay()
        pk, pv = plain(new)
        check(torch.equal(mk.view(torch.int32), pk.view(torch.int32))
              and torch.equal(mv.view(torch.int32), pv.view(torch.int32)),
              f"c4: replayed sorted_merge #{i} != plain")
    scratch = merge_ops._scratch[(mk.device.index, side.cuda_stream)]
    torch.cuda.synchronize()
    epochs = [int(scratch[0]) >> 32]
    scratch[0] = (merge_ops.EPOCHS - 2) << 32
    for i in range(2):
        inp = inputs()
        with torch.cuda.stream(side):
            got = merge_ops.merge_compact_sharded(*inp)
        torch.cuda.synchronize()
        pk, pv = plain(inp)
        check(torch.equal(got[0].view(torch.int32), pk.view(torch.int32))
              and torch.equal(got[1].view(torch.int32),
                              pv.view(torch.int32)),
              f"c4: sorted_merge {'at the wrap' if i == 0 else 'after'} "
              f"!= plain")
        epochs.append(int(scratch[0]) >> 32)
        if i == 0:
            check(int(scratch[0]) == 0 and int(scratch[1]) == 0
                  and not bool(scratch[2:].any()),
                  "c4: the wrap call left its scratch uncleared")
    check(epochs[1:] == [0, 1], f"c4: epochs after the wrap {epochs}")
    out["merge_replays"] = 2
    out["merge_epochs"] = epochs
    return out


def megapass_phase(torch, dev, seed, pq, init, cap, counters, threads,
                   ops=OPS_PER_THREAD, timing=True, n_lists=MEGA_LISTS,
                   out=print):
    """Parts a-e (:func:`mega_lists`, :func:`mega_contract`,
    :func:`mega_engine` with the megapass on and off, :func:`mega_timing`,
    :func:`c4_checks`).  ``pq``: the pq-sharded phase's queue, its 4,000,000
    prefilled keys on K = 4 shards of ``cap`` slots.  The launches are the
    megapass engine's (part c, megapass on): the main path's count.  Each
    part's line is printed as the part ends."""
    from repro_torch.core.sharded_pq import ShardedBatchedPQ

    s, printed = {}, []

    def flush():
        for line in megapass_lines(s, dev, None):
            if line not in printed:
                printed.append(line)
                out(line)
    t0 = time.perf_counter()
    small = ShardedBatchedPQ(1024, C_MAX, n_shards=4, values=np.floor(
        np.random.default_rng([seed, 34]).uniform(0, 100, 24)), device=dev)
    s["lists"] = mega_lists(torch, dev, seed, pq, small, n_lists)
    s["lists"]["graph_captures"] = pq.graph_captures + small.graph_captures
    s["lists_s"] = time.perf_counter() - t0
    flush()
    if dev.type == "cuda":
        s["contract"] = mega_contract(torch, pq, counters, seed)
        flush()
    for on in (True, False):
        t0 = time.perf_counter()
        s["engine" if on else "alternating"] = mega_engine(
            torch, dev, seed, init, cap, counters, threads, ops, on)
        s[("engine" if on else "alternating") + "_s"] = \
            time.perf_counter() - t0
        flush()
    check(s["engine"]["dispatches"] < s["engine"]["rounds"],
          "megapass: the engine never fused two rounds")
    s["launches"] = s["engine"]["launches"]
    if dev.type == "cuda":
        if timing:
            t0 = time.perf_counter()
            s["timing"] = mega_timing(torch, pq, seed)
            s["timing_s"] = time.perf_counter() - t0
            flush()
        s["c4"] = c4_checks(torch, dev, seed, pq)
        flush()
    return s


def megapass_lines(s, dev, seconds):
    li = s["lists"]
    yield (f"megapass lists: {li['lists']} seeded round lists ("
           f"{min(MEGA_SMALL, li['lists'])} on a near-empty heap) at {li['rows']} padded "
           f"rows: replay == eager == plain, bit for bit (heaps, outs, "
           f"every handle's answers; pairs consumed in reverse); "
           f"{li['graph_captures']} graph captures, memory_reserved "
           f"{li['reserved_before']} -> {li['reserved_after']} "
           f"({s['lists_s']:.1f} s)")
    if "contract" in s:
        c = s["contract"]
        yield (f"megapass contract: a {c['rows']}-row dispatch and its "
               f"handles made one blocking fetch and no other sync, one "
               f"graph replay, heap launches {c['captured']} (the "
               f"captured counts)")
    for key in ("engine", "alternating"):
        if key not in s:
            continue
        e = s[key]
        yield (f"megapass {key}: {e['ops_per_s']:.1f} ops/s ({e['ops']} "
               f"ops in {e['seconds']:.3f} s, 45/45/10 insert/extract_min/"
               f"peek_min), {e['rounds']} rounds in {e['dispatches']} "
               f"dispatches (rounds_per_dispatch "
               f"{e['rounds_per_dispatch']:.3f}), graph captures "
               f"{e['graph_captures']}, replays {e['graph_replays']}, "
               f"launches {_nonzero(e['launches'])}; every answer and the "
               f"final multiset equal to SequentialBatchedPQ's (set-up "
               f"{e['setup_s']:.1f} s, replay {e['replay_s']:.1f} s; "
               f"{s[key + '_s']:.1f} s)")
    for R, t in s.get("timing", {}).items():
        yield (f"megapass timing R={R}: replay host ms "
               f"{t['replay_host_ms']:.4f} device ms "
               f"{t['replay_device_ms']:.4f}; eager host ms "
               f"{t['eager_host_ms']:.4f} device ms "
               f"{t['eager_device_ms']:.4f}; capture ms "
               f"{t['capture_ms']:.3f} (once)")
    if "c4" in s:
        c = s["c4"]
        yield (f"megapass c4: heap_kmin replayed at ne {c['kmin_ne']} == "
               f"plain; sorted_merge replayed {c['merge_replays']}x on new "
               f"inputs == plain; epoch wrap on the card right, epochs "
               f"{c['merge_epochs']}")
    if seconds is not None:
        yield f"megapass: {seconds:.1f} s"


# ---------------------------------------------------------------------------
# label_prop: every launch held against the plain version
# ---------------------------------------------------------------------------
def random_tree(rng, n):
    """Random spanning tree on [0, n) as endpoint arrays: vertex perm[i]
    hangs from a uniform earlier vertex (bench_graph's ``_random_tree``,
    vectorized)."""
    perm = rng.permutation(n).astype(np.int32)
    parent = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    return perm[1:], perm[parent]


class LabelPropCheck:
    """Runs ``propagate`` (the kernel on CUDA tensors) and
    ``propagate_plain`` on clones of the same output buffer and compares
    the labels element-wise and the step counts; any difference raises."""

    def __init__(self):
        self.calls = 0
        self.max_abs_err = 0.0

    def __call__(self, eu, ev, out, **kw):
        import torch

        from repro_torch.kernels.label_prop import propagate, propagate_plain

        got, want = out.clone(), out.clone()
        it_k = int(propagate(eu, ev, got, **kw))
        it_p = int(propagate_plain(eu, ev, want, **kw))
        err = float((got.long() - want.long()).abs().max()) \
            if got.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        self.calls += 1
        if not torch.equal(got, want) or it_k != it_p:
            raise AssertionError(
                f"label_prop: kernel != plain ({sorted(kw)}): max_abs_err "
                f"{err}, steps {it_k} vs {it_p}")
        return got, it_k


def label_prop_cases(torch, dev, seed, n):
    """The checked graphs: ``(name, eu, ev, kw)`` on the card, ``kw`` the
    edge options of ``propagate`` (the valid mask)."""
    rng = np.random.default_rng([seed, 7])

    def t(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype=dt)

    tu, tv = random_tree(rng, n)
    cases = []
    # the graph's edge buffer: half the tree at random slots, junk vertex
    # ids in the invalid slots (valid masks them), the scratch slot last
    cap = (n - 1) + 2 * C_MAX
    eu = rng.integers(0, n, cap + 1).astype(np.int32)
    ev = rng.integers(0, n, cap + 1).astype(np.int32)
    valid = np.zeros(cap + 1, bool)
    keep = np.flatnonzero(rng.random(n - 1) < 0.5)
    slots = rng.choice(cap, keep.size, replace=False)
    eu[slots], ev[slots], valid[slots] = tu[keep], tv[keep], True
    cases.append(("tree buffer", t(eu), t(ev),
                  dict(valid=t(valid, torch.bool))))
    # (0,0) padding, self-loops and duplicate edges
    E = n // 2
    pu, pv = rng.integers(0, n, E), rng.integers(0, n, E)
    pad = rng.random(E) < 0.2
    pu[pad] = pv[pad] = 0
    loop = rng.random(E) < 0.1
    pv[loop] = pu[loop]
    dup = rng.integers(0, E, E // 10)
    pu[-dup.size:], pv[-dup.size:] = pu[dup], pv[dup]
    cases.append(("padding+loops+dups", t(pu), t(pv), {}))
    # isolated vertices: edges among the first n // 8 only
    m = n // 8
    cases.append(("isolated", t(rng.integers(0, m, m)),
                  t(rng.integers(0, m, m)), {}))
    cases.append(("empty", t(np.zeros(0, np.int32)),
                  t(np.zeros(0, np.int32)), {}))
    # a chain of n vertices, edges in shuffled order
    order = rng.permutation(n - 1)
    cases.append(("chain", t(order), t(order + 1), {}))
    # a forest: a random tree with a tenth of its edges dropped
    fu, fv = random_tree(rng, n)
    keep = rng.random(n - 1) < 0.9
    cases.append(("forest", t(fu[keep]), t(fv[keep]), {}))
    return cases


def _shuffled(torch, rng, eu, ev, kw, k=None):
    """The same edge slots in another order: all of them, or the live
    prefix of ``k`` slots only (the slots past it stay where they are)."""
    k = eu.numel() if k is None else k
    p = torch.cat([torch.from_numpy(rng.permutation(k)),
                   torch.arange(k, eu.numel())]).to(eu.device)
    kw = dict(kw)
    if "valid" in kw:
        kw["valid"] = kw["valid"][p]
    return eu[p], ev[p], kw


def label_prop_phase(torch, dev, seed, n):
    """Every case step by step (``max_iters = 1`` from each iterate, each
    held against the plain step; the steps counted), then as one whole
    fixpoint (the fixpoint body) in 3 shuffled edge orders; then the
    device gates, the contracted merge at the graph's pending shape (live
    prefixes shuffled 3 times), the relabel form on both sides of
    ``SMALL_E`` and the union-find form.
    Returns the check record, the inputs kept for timing and the
    propagation steps of each case's fixpoint."""
    from repro_torch.kernels.label_prop import propagate_plain
    from repro_torch.kernels.label_prop.ops import SMALL_E

    chk = LabelPropCheck()
    rng = np.random.default_rng([seed, 8])
    yes = torch.ones((), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    ident = torch.arange(n, dtype=torch.int32, device=dev)
    timed = {}
    steps = {}
    for name, eu, ev, kw in label_prop_cases(torch, dev, seed, n):
        l, count = ident.clone(), 0
        while True:                          # every step of the fixpoint
            l2, _ = chk(eu, ev, torch.empty_like(l), init=l, max_iters=1,
                        **kw)
            count += 1
            if torch.equal(l2, l):
                break
            l = l2
        steps[name] = count
        for _ in range(3):                   # the fixpoint, 3 edge orders
            su, sv, skw = _shuffled(torch, rng, eu, ev, kw)
            fixed, ret = chk(su, sv, torch.empty_like(l), **skw)
            check(ret == 1 and torch.equal(fixed, l),
                  f"label_prop {name}: the fixpoint differs from its steps")
        if name == "chain":
            timed["chain"] = dict(eu=eu, ev=ev)
        if name == "tree buffer":
            timed.update(eu=eu, ev=ev, valid=kw["valid"], labels=fixed,
                         iters=count)
            # the read pass's gates: when / unless decide on the device
            chk(eu, ev, ident.clone(), when=yes, **kw)
            chk(eu, ev, ident.clone(), when=no, **kw)
            chk(eu, ev, ident.clone(), unless=yes, **kw)
            chk(eu, ev, ident.clone(), init=ident, when=no, **kw)
    # the contracted-merge form: pending inserts of other tree edges into
    # the tree buffer's labels, the live lanes counted on the device; then
    # the relabel form past the merge body's slots (the fixpoint body)
    eu, ev, valid, base = (timed[k] for k in ("eu", "ev", "valid",
                                              "labels"))
    tu, tv = random_tree(np.random.default_rng([seed, 7]), n)
    for width, lives in ((2 * C_MAX + 1, (1, 5, 2 * C_MAX, 0)),
                         (SMALL_E, (SMALL_E,)), (SMALL_E + 1, (SMALL_E,))):
        for k in lives:
            pick = rng.integers(0, n - 1, width)
            pend = np.stack([rng.integers(0, n, width),
                             rng.integers(0, n, width)]).astype(np.int32)
            pend[0, :k], pend[1, :k] = tu[pick[:k]], tv[pick[:k]]
            pend = torch.from_numpy(pend).to(dev)
            live = torch.full((), k, dtype=torch.int32, device=dev)
            merged = None
            for _ in range(3):               # live prefixes reordered
                pu, pv, _ = _shuffled(torch, rng, pend[0], pend[1], {}, k)
                got, _ = chk(pu, pv, base.clone(), e_live=live,
                             relabel=True, unless=no)
                check(merged is None or torch.equal(got, merged),
                      "label_prop: the merge depends on the slot order")
                merged = got
            chk(pend[0], pend[1], base.clone(), e_live=live, relabel=True,
                unless=yes)
            if not k:
                continue
            if width == 2 * C_MAX + 1:
                timed["merge"] = dict(pu=pend[0], pv=pend[1], live=live,
                                      labels=base, changed=int(
                                          (merged != base).sum()))
                for m_it in (1, 2):          # steps of the contracted graph
                    chk(pend[0], pend[1], base.clone(), e_live=live,
                        relabel=True, max_iters=m_it)
            full = torch.empty_like(base)
            propagate_plain(torch.cat([eu[valid], pend[0, :k]]),
                            torch.cat([ev[valid], pend[1, :k]]), full)
            check(torch.equal(merged, full),
                  "label_prop: the merge form != the full rebuild")
    # the union-find form: ≤ c_max unions (chain and random) on a labeling,
    # each batch in 3 orders
    uf = base.clone()
    for b in range(4):
        u = rng.integers(0, n, C_MAX)
        v = np.where(rng.random(C_MAX) < 0.5, (u + 1) % n,
                     rng.integers(0, n, C_MAX))
        u = torch.from_numpy(u.astype(np.int32)).to(dev)
        v = torch.from_numpy(v.astype(np.int32)).to(dev)
        prev, nxt = uf, None
        for _ in range(3):
            su, sv, _ = _shuffled(torch, rng, u, v, {})
            got, _ = chk(su, sv, prev.clone(), relabel=True)
            check(nxt is None or torch.equal(got, nxt),
                  "label_prop: the union-find form depends on the order")
            nxt = got
        if b == 0:
            timed["uf"] = dict(pu=u, pv=v, labels=prev,
                               changed=int((nxt != prev).sum()))
        uf = nxt
    check(chk.calls >= 50, f"label_prop: only {chk.calls} checked launches")
    return chk, timed, steps


def time_label_prop(torch, timed):
    """Per-launch times (``_per_launch_ms``) at the graph's full-rebuild
    shape: the whole fixpoint by the fixpoint body (``ms``) and, for
    comparison in the same run, by the step body (``step_fixpoint_ms``,
    the full rebuild before the fixpoint body); the fixpoint body on the
    chain; one step from the identity; the contracted merge at the graph's
    pending shape (33 slots, 32 live); the union-find form's 16 unions; each body gated off;
    the plain versions beside them.  The bounds count each input once and
    each output once over 3.35 TB/s (the fixpoint: eu, ev, valid in,
    labels out; a step: its labels in as well; a merge: the labels in,
    the live slots' endpoints and the labels it changes), against a min
    and a compare per edge endpoint and per vertex (one pass for the
    fixpoint, one per step) over 67 TOP/s."""
    from repro_torch.kernels.label_prop import propagate, propagate_plain
    from repro_torch.kernels.label_prop.ops import propagate_body

    eu, ev, valid, iters = (timed[k] for k in ("eu", "ev", "valid",
                                               "iters"))
    n, E = timed["labels"].numel(), eu.numel()
    ident = torch.arange(n, dtype=torch.int32, device=eu.device)
    yes = torch.ones((), dtype=torch.bool, device=eu.device)
    no = torch.zeros((), dtype=torch.bool, device=eu.device)
    ring = [torch.empty_like(ident) for _ in range(RING)]
    plain_ring = ring[:PLAIN_RING]
    m, uf, ch = timed["merge"], timed["uf"], timed["chain"]

    def merge(fn, rec, **kw):
        return lambda r: fn(rec["pu"], rec["pv"], r, relabel=True, **kw)

    def held(fn, a_in=ident):
        return _per_launch_ms(torch, fn, ring, a_in, hold=True)

    out = {
        "ms": held(lambda r: propagate(eu, ev, r, valid=valid, when=yes)),
        "step_fixpoint_ms": held(lambda r: propagate_body(
            "step", eu, ev, r, valid=valid, when=yes)),
        "plain_ms": _per_launch_ms(torch, lambda r: propagate_plain(
            eu, ev, r, valid=valid, when=yes), plain_ring, ident,
            hold=False),
        "chain_ms": held(lambda r: propagate(ch["eu"], ch["ev"], r)),
        "gated_off_ms": held(lambda r: propagate(eu, ev, r, valid=valid,
                                                 when=no)),
        "step_ms": held(lambda r: propagate(
            eu, ev, r, init=ident, valid=valid, max_iters=1)),
        "step_plain_ms": _per_launch_ms(torch, lambda r: propagate_plain(
            eu, ev, r, init=ident, valid=valid, max_iters=1), plain_ring,
            ident, hold=False),
        "merge_ms": held(merge(propagate, m, e_live=m["live"], unless=no),
                         m["labels"]),
        "merge_plain_ms": _per_launch_ms(torch, merge(
            propagate_plain, m, e_live=m["live"], unless=no), plain_ring,
            m["labels"], hold=False),
        "merge_gated_off_ms": held(merge(propagate, m, e_live=m["live"],
                                         unless=yes), m["labels"]),
        "uf_merge_ms": held(merge(propagate, uf), uf["labels"]),
        "tree_steps": iters, "n": n, "edge_slots": E,
        "live_edges": int(valid.sum()), "merge_slots": m["pu"].numel(),
        "merge_live": int(m["live"]), "merge_changed": m["changed"],
        "uf_unions": uf["pu"].numel(), "uf_changed": uf["changed"],
        "library_ms": None,
    }
    byte_ms = (9 * E + 1 + 4 * n) / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * (2 * E + n) / F32_OPS_PER_S * 1e3
    out["bound_ms"] = max(byte_ms, op_ms)
    out["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    out["step_bound_ms"] = max((9 * E + 8 * n) / HBM_BYTES_PER_S * 1e3,
                               2 * (2 * E + n) / F32_OPS_PER_S * 1e3)
    out["merge_bound_ms"] = (4 * n + 8 * out["merge_live"] + 4
                             + 4 * m["changed"]) / HBM_BYTES_PER_S * 1e3
    out["uf_bound_ms"] = (4 * n + 8 * out["uf_unions"]
                          + 4 * uf["changed"]) / HBM_BYTES_PER_S * 1e3
    return out


def label_prop_line(chk, steps, t, seconds):
    """The ``kernels: label_prop`` line of phase 6 (and ``--label-prop``)."""
    return (
        f"kernels: label_prop == plain on {chk.calls} launches (max_abs_err "
        f"{chk.max_abs_err}; propagation steps to the fixpoint {steps}; "
        f"{seconds:.1f} s); " + (
            "timing not measured" if not t else
            f"full rebuild ms {t['ms']:.6f} (fixpoint body; n {t['n']}, "
            f"{t['edge_slots']} edge slots, {t['live_edges']} live) "
            f"bound_ms {t['bound_ms']:.3e} ({t['bound_by']}), by the step "
            f"body {t['step_fixpoint_ms']:.6f} ({t['tree_steps']} "
            f"steps), plain_ms {t['plain_ms']:.6f}; chain ms "
            f"{t['chain_ms']:.6f}; gated off ms {t['gated_off_ms']:.6f}; "
            f"step ms {t['step_ms']:.6f} plain {t['step_plain_ms']:.6f} "
            f"bound {t['step_bound_ms']:.3e}; merge ms {t['merge_ms']:.6f} "
            f"({t['merge_slots']} slots, {t['merge_live']} live, "
            f"{t['merge_changed']} labels changed; plain "
            f"{t['merge_plain_ms']:.6f}; gated off "
            f"{t['merge_gated_off_ms']:.6f}) bound "
            f"{t['merge_bound_ms']:.3e}; union-find merge ms "
            f"{t['uf_merge_ms']:.6f} ({t['uf_unions']} unions, "
            f"{t['uf_changed']} labels changed) bound "
            f"{t['uf_bound_ms']:.3e}; library_ms None"))


# ---------------------------------------------------------------------------
# the graph: §5.1 connectivity under 8 client threads, then a replay
# ---------------------------------------------------------------------------
def one_fetch(torch, module, fn):
    """Run ``fn()`` on the card with every synchronising call raising
    (``torch.cuda.set_sync_debug_mode("error")``), except ``module``'s
    ``_host_fetch``, which is counted and must run exactly once."""
    real = module._host_fetch
    calls = []

    def counting(tree):
        calls.append(1)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(tree)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    module._host_fetch = counting
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        module._host_fetch = real
    check(len(calls) == 1, f"{len(calls)} blocking fetches, want 1")
    return got


def drive_mixed(engine, threads, ops, seed, draw):
    """``threads`` clients of ``draw(rng) -> (method, input)``; returns
    every client's ``(method, input, answer)`` list and the seconds."""
    logs = [[] for _ in range(threads)]
    errors = []

    def client(tid):
        try:
            r = np.random.default_rng([seed, 9, tid])
            for _ in range(ops):
                m, i = draw(r)
                logs[tid].append((m, i, engine.execute(m, i)))
        except BaseException as exc:       # re-raised on the main thread
            errors.append(exc)

    ts = [threading.Thread(target=client, args=(t,), daemon=True)
          for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "client threads hung")
    if errors:
        raise errors[0]
    return logs, seconds


def _norm(e):
    return (min(e), max(e))


def graph_replay(torch, g, tree, n_replay, seed):
    """Seeded single-thread combined update+read batches through the
    kernel pass and the plain pass on clones of ``g``'s state: every
    state field bit-equal after each batch, update answers equal to the
    port's ``DynamicGraph`` after each batch and reads every 10th batch
    and at the end; on the card every 10th kernel batch runs under
    :func:`one_fetch`.  Returns (batches, full rebuilds, fast merges)."""
    from repro_torch.core import device_graph as dg
    from repro_torch.core.dynamic_graph import DynamicGraph
    from repro_torch.kernels.label_prop import propagate_plain

    rng = np.random.default_rng([seed, 10])
    live = g.edges()
    pair = []
    for prop in (None, propagate_plain):
        h = dg.DeviceGraph(g.n, edge_capacity=g.capacity, c_max=g.c_max,
                           n_shards=g.n_shards, device=g.device)
        h.state = dg.clone_state(g.state)
        h._n_edges = len(live)
        if prop is not None:
            h._prop = prop
        pair.append(h)
    gk, gp = pair
    host = DynamicGraph(g.n, device=g.device)
    host.edges = set(live)
    n = g.n
    for b in range(n_replay):
        kind = b % 4     # inserts, mixed, delete-heavy, a few inserts
        k = int(rng.integers(1, 5)) if kind == 3 else \
            int(rng.integers(1, 2 * C_MAX + 9))
        ms, ins = [], []
        for _ in range(k):
            e = tree[int(rng.integers(len(tree)))]
            if rng.random() < 0.1:
                e = (e[0], e[0])                          # self-loop
            elif ins and rng.random() < 0.2:
                e = ins[int(rng.integers(len(ins)))]      # duplicate
            if kind in (0, 3):
                m = "insert"
            elif kind == 1:
                m = "insert" if rng.random() < 0.5 else "delete"
            else:
                m = "delete" if rng.random() < 0.8 else "insert"
            ms.append(m)
            ins.append(e)
        q = [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(8)]
        q += [(e[0], e[1]) for e in ins[:8]]
        if b % 10 == 0 and g.device.type == "cuda":
            hk, ak = one_fetch(torch, dg, lambda: (
                gk.update_batch_async(ms, ins), gk.connected_batch(q)))
        else:
            hk = gk.update_batch_async(ms, ins)
            ak = gk.connected_batch(q)
        hp = gp.update_batch_async(ms, ins)
        ap = gp.connected_batch(q)
        check(all(torch.equal(x, y) for x, y in zip(gk.state, gp.state)),
              f"graph replay batch {b}: kernel state != plain state")
        rk = hk.result()
        check(rk == hp.result() and ak == ap,
              f"graph replay batch {b}: kernel answers != plain answers")
        want = [host.apply(m, e) for m, e in zip(ms, ins)]
        check(rk == want, f"graph replay batch {b}: updates {rk} != "
                          f"DynamicGraph {want}")
        if b % 10 == 9 or b == n_replay - 1:
            check(ak == host.read_batch(["connected"] * len(q), q),
                  f"graph replay batch {b}: reads != DynamicGraph")
    check(gk.edges() == host.edges, "graph replay: final edge sets differ")
    return (n_replay, gk.full_rebuilds() - g.full_rebuilds(),
            gk.fast_merges() - g.fast_merges())


def graph_phase(torch, dev, seed, n, threads, ops, n_replay, counters):
    from repro_torch.core.read_opt import batched_read_optimized
    from repro_torch.kernels.label_prop.ref import components_reference

    t0 = time.perf_counter()
    g, tree = tree_graph(torch, dev, seed, n)  # labels current before
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prepop_s = time.perf_counter() - t0
    initial = g.edges()
    half = np.flatnonzero(np.random.default_rng([seed, 6]).random(n - 1)
                          < 0.5)
    check(initial == {_norm(tree[i]) for i in half},
          "graph: the loaded edges are not the tree's half")
    rebuilds0, fast0 = g.full_rebuilds(), g.fast_merges()
    elim0 = g.eliminated_ops
    engine = batched_read_optimized(g)

    def draw(r):
        p = r.random() * 100
        if p < READ_PCT:
            return "connected", (int(r.integers(n)), int(r.integers(n)))
        e = tree[int(r.integers(len(tree)))]
        return ("insert" if p < READ_PCT + (100 - READ_PCT) / 2
                else "delete"), e

    (logs, seconds), launches = counted(
        torch, dev, "graph", counters, ("label_prop",),
        lambda: drive_mixed(engine, threads, ops, seed, draw))
    rebuilds = g.full_rebuilds() - rebuilds0
    fast = g.fast_merges() - fast0
    check(rebuilds > 0, "graph: no full rebuild on the main path")
    check(fast > 0, "graph: no fast-path merge on the main path")
    # per-edge-class conservation
    delta = {}
    for log in logs:
        for m, e, res in log:
            if m != "connected" and res:
                delta[_norm(e)] = delta.get(_norm(e), 0) + (
                    1 if m == "insert" else -1)
    final = g.edges()
    for e in initial | set(delta) | final:
        want = (e in initial) + delta.get(e, 0)
        check(want in (0, 1) and (e in final) == bool(want),
              f"graph: edge {e} not conserved ({want}, {e in final})")
    labels = np.asarray(g.labels(), np.int32)
    check(np.array_equal(labels, components_reference(n, final)),
          "graph: final labels != the union-find oracle")
    n_ops = threads * ops
    stats = {
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "eliminated": g.eliminated_ops - elim0,
        "full_rebuilds": rebuilds, "fast_merges": fast,
        "launches": launches, "prepopulate_s": prepop_s,
        "live_edges": len(final),
        "device_bytes": sum(t.numel() * t.element_size() for t in g.state),
    }
    stats["replayed"], stats["replay_rebuilds"], stats["replay_merges"] = \
        graph_replay(torch, g, tree, n_replay, seed)
    stats["keep"] = (g, tree)             # the placement phase's twins
    return stats


# ---------------------------------------------------------------------------
# the union-find under 8 client threads, then a replay
# ---------------------------------------------------------------------------
def uf_replay(torch, uf, n_replay, seed):
    """Seeded union batches through the kernel pass and the plain pass on
    clones of ``uf``'s labels (bit-equal after every batch), answers equal
    to ``SequentialUnionFind.update_batch`` (reads every 10th batch)."""
    from repro_torch.core.batched_union_find import BatchedUnionFind, UFState
    from repro_torch.core.seq_union_find import SequentialUnionFind
    from repro_torch.kernels.label_prop import propagate_plain

    rng = np.random.default_rng([seed, 11])
    n = uf.n
    uk = BatchedUnionFind(n, c_max=uf.c_max, device=uf.device)
    up = BatchedUnionFind(n, c_max=uf.c_max, device=uf.device)
    uk.state = UFState(uf.state.labels.clone())
    up.state = UFState(uf.state.labels.clone())
    up._prop = propagate_plain
    oracle = SequentialUnionFind(n)
    oracle.load_labels(uf.labels())
    for b in range(n_replay):
        k = int(rng.integers(1, 2 * C_MAX + 5))
        ins = []
        for _ in range(k):
            if ins and rng.random() < 0.15:
                ins.append(ins[int(rng.integers(len(ins)))])   # repeat
                continue
            u = int(rng.integers(n))
            ins.append((u, (u + 1) % n) if rng.random() < 0.5
                       else (u, int(rng.integers(n))))
        ms = ["union"] * k
        rk, rp = uk.update_batch(ms, ins), up.update_batch(ms, ins)
        check(torch.equal(uk.state.labels, up.state.labels),
              f"unionfind replay batch {b}: kernel labels != plain labels")
        want = oracle.update_batch(ms, ins)
        check(rk == rp == want, f"unionfind replay batch {b}: {rk} != "
                                f"oracle {want}")
        if b % 10 == 9:
            qm = ["find", "connected", "components"]
            qi = [ins[0][0], (ins[0][0], ins[-1][1]), None]
            check(uk.read_batch(qm, qi) == oracle.read_batch(qm, qi),
                  f"unionfind replay batch {b}: reads != oracle")
    check(uk.labels() == oracle.labels(),
          "unionfind replay: final labels != oracle")
    return n_replay


def uf_phase(torch, dev, seed, n, threads, ops, n_replay, counters):
    from repro_torch.core.batched_union_find import BatchedUnionFind
    from repro_torch.core.pc_union_find import pc_union_find
    from repro_torch.kernels.label_prop.ref import components_reference

    uf = BatchedUnionFind(n, c_max=C_MAX, device=dev)
    engine = pc_union_find(uf)

    def draw(r):
        p = r.random() * 100
        if p < READ_PCT:
            k = int(r.integers(3))
            if k == 0:
                return "find", int(r.integers(n))
            if k == 1:
                return "connected", (int(r.integers(n)), int(r.integers(n)))
            return "components", None
        u = int(r.integers(n))
        return "union", ((u, (u + 1) % n) if r.random() < 0.5
                         else (u, int(r.integers(n))))

    (logs, seconds), launches = counted(
        torch, dev, "unionfind", counters, ("label_prop",),
        lambda: drive_mixed(engine, threads, ops, seed, draw))
    unions = [i for log in logs for m, i, _ in log if m == "union"]
    check(np.array_equal(np.asarray(uf.labels(), np.int32),
                         components_reference(n, unions)),
          "unionfind: final labels != the oracle of every union")
    n_ops = threads * ops
    return {
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "unions": len(unions), "launches": launches,
        "device_bytes": uf.state.labels.numel() * 4,
        "replayed": uf_replay(torch, uf, n_replay, seed),
    }


# ---------------------------------------------------------------------------
# sorted_merge: every launch held against the plain version
# ---------------------------------------------------------------------------
def _bits_err(torch, got, want):
    """(bit-equal?, largest |got - want| over the elements whose bits
    differ, NaN counting as inf)."""
    gb, wb = got.view(torch.int32), want.view(torch.int32)
    d = torch.where(gb == wb, 0.0, (got.double() - want.double()).abs())
    err = float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0
    return torch.equal(gb, wb), err


class MergeCheck:
    """Runs ``merge_compact_sharded`` (the kernel on CUDA tensors) and
    ``merge_compact_plain`` on the same inputs into separate outputs and
    compares them bit for bit; with ``ref``, each shard also against the
    numpy oracle.  Any difference raises."""

    def __init__(self):
        self.calls = 0
        self.max_abs_err = 0.0

    def __call__(self, name, inputs, ref=False):
        import torch

        from repro_torch.kernels.sorted_merge import (merge_compact_plain,
                                                      merge_compact_sharded)
        from repro_torch.kernels.sorted_merge.ref import \
            merge_compact_reference

        got = merge_compact_sharded(*inputs)
        want = merge_compact_plain(*inputs)
        self.calls += 1
        for g, w, what in zip(got, want, ("keys", "vals")):
            same, err = _bits_err(torch, g, w)
            self.max_abs_err = max(self.max_abs_err, err)
            check(same, f"sorted_merge {name} {what}: kernel != plain "
                        f"(max_abs_err {err})")
        if ref:
            host = [t.cpu().numpy() for t in inputs]
            gk, gv = (t.cpu().numpy() for t in got)
            for k in range(gk.shape[0]):
                rk, rv = merge_compact_reference(*(h[k] for h in host))
                check(np.array_equal(rk.view(np.int32), gk[k].view(np.int32))
                      and np.array_equal(rv.view(np.int32),
                                         gv[k].view(np.int32)),
                      f"sorted_merge {name}: shard {k} != numpy oracle")
        return got


def merge_inputs(torch, dev, rng, K, n, c, mode, bc, *, junk=True,
                 zeros=False, full=False, fill=None, b_at=None):
    """One seeded merge-compact input on the card, shaped as a map pass
    makes it: per shard a sorted body of ``s`` distinct keys (+inf past
    it; ``s`` drawn from [n/2 - bc, n - bc], or ``fill``), ``keep`` by
    ``mode`` (``all``, ``none``, ``few`` — at most 16 deletions —,
    ``half``, ``empty`` — no body at all), and a sorted run of ``bc`` new
    keys in ``c`` lanes.  ``junk`` writes unsorted values, ±inf and NaN
    into dropped slots and dead lanes; ``zeros`` puts a raw -0.0 key into
    even shards and a flushed subnormal into odd ones; ``full`` makes the
    merged length exactly ``n``; ``b_at`` ``"before"`` / ``"after"`` gives
    the run the smallest / largest keys, below or above all of A."""
    ak = np.full((K, n), np.inf, np.float32)
    av = np.full((K, n), np.inf, np.float32)
    keep = np.zeros((K, n), bool)
    bk = np.full((K, c), np.inf, np.float32)
    bv = np.full((K, c), np.inf, np.float32)
    bcount = np.zeros(K, np.int32)
    idx = np.arange(n)
    for k in range(K):
        b = min(bc, c)
        s = 0 if mode == "empty" else n if full else fill if fill else \
            int(rng.integers(max(n // 2 - b, 0), n - b + 1))
        pool = rng.choice(4 * (n + c), s + b, replace=False) - 2 * (n + c)
        if zeros and s + b and not (pool == 0).any():
            pool[int(rng.integers(s + b))] = 0
        keys = pool.astype(np.float32)
        if b_at is not None:
            keys = np.sort(keys)
            if b_at == "before":
                keys = np.roll(keys, -b)
        if zeros:
            keys[keys == 0] = np.float32(-0.0) if k % 2 == 0 else \
                np.float32(1e-40)
            keys = np.where((np.abs(keys) < np.finfo(np.float32).tiny)
                            & (keys != 0), np.float32(0.0), keys)
        a = keys[:s][np.argsort(keys[:s], kind="stable")]
        run = np.sort(keys[s:])
        vals = rng.uniform(-10, 10, s + b).astype(np.float32)
        ak[k, :s], av[k, :s] = a, vals[:s]
        kp = idx < s
        if mode in ("none", "empty"):
            kp[:] = False
        elif mode == "few":
            kp[rng.choice(s, b if full else min(16, s), replace=False)] = False
        elif mode == "half":
            kp &= rng.random(n) < 0.5
        keep[k] = kp
        bk[k, :b], bv[k, :b], bcount[k] = run, vals[s:], b
        if junk:
            dead = np.flatnonzero(~kp)
            dead = dead[rng.random(dead.size) < 0.5]
            pick = rng.integers(0, 4, dead.size)
            ak[k, dead] = np.select(
                [pick == 0, pick == 1, pick == 2],
                [np.float32(np.inf), np.float32(-np.inf), np.float32(np.nan)],
                rng.uniform(-1e6, 1e6, dead.size).astype(np.float32))
            av[k, dead] = rng.uniform(-1e6, 1e6, dead.size)
            bk[k, b:] = rng.uniform(-1e6, 1e6, c - b)
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (ak, av, keep, bk, bv, bcount))


MERGE_WIDE = 1024                  # sorted_merge's widest B run


def merge_sizes(n_map):
    """The N of the merge checks: the map's per-shard capacity, 1000, and
    one either side of the kernel's tile (read off the built kernel; the
    host rehearsal, which builds none, takes the source's 2,048)."""
    import torch

    tile = 2048
    if torch.cuda.is_available():
        from repro_torch.kernels.sorted_merge import ops
        tile = ops._kernel_limits()[0]
    return (n_map, 1000, tile - 1, tile + 1)


def sorted_merge_phase(torch, dev, seed, n_map, fill):
    """The merge at the map's per-shard capacity (K = 4 and K = 1), at
    N = 1000 and one either side of the kernel's tile: every keep mode at
    b_count 0, 1 and 16, junk in the dropped slots, empty A, merged length
    exactly N, signed and flushed zeros, the B run below or above all of
    A; past 2,048 slots also B runs of 1,024 lanes (full, half full, below
    A); small cases also against the numpy oracle.  Returns
    the check record and the (checked) inputs kept for timing: a full map
    pass at the map phase's fill, K = 4 shards of ``fill`` keys each with
    16 deletions and 16 new keys, and at the same shape keep-none and
    empty A (where the pad CTAs write whole rows)."""
    chk = MergeCheck()
    rng = np.random.default_rng([seed, 14])
    timed = {"fill": merge_inputs(torch, dev, rng, 4, n_map, C_MAX, "few",
                                  C_MAX, junk=False, fill=fill)}
    chk("K=4 map fill", timed["fill"])
    for name in ("none", "empty"):
        timed[name] = merge_inputs(torch, dev, rng, 4, n_map, C_MAX, name,
                                   C_MAX, junk=False, fill=fill)
        chk(f"K=4 map {name}", timed[name])
    for K in (4, 1):
        for n in merge_sizes(n_map):
            ref = n <= 4096
            for i, (mode, bc) in enumerate(
                    (m, b) for m in ("all", "none", "few", "half")
                    for b in (0, 1, C_MAX)):
                inp = merge_inputs(torch, dev, rng, K, n, C_MAX, mode, bc,
                                   junk=i % 2 == 0)
                chk(f"K={K} N={n} {mode} b_count={bc}", inp, ref=ref)
            cases = [("empty A", C_MAX, dict(mode="empty", bc=C_MAX)),
                     ("merged == N", C_MAX, dict(mode="few", bc=C_MAX,
                                                 full=True)),
                     ("zeros", C_MAX, dict(mode="few", bc=C_MAX,
                                           zeros=True)),
                     ("B before A", C_MAX, dict(mode="few", bc=C_MAX,
                                                b_at="before")),
                     ("B after A", C_MAX, dict(mode="half", bc=C_MAX,
                                               b_at="after"))]
            if n > 2 * MERGE_WIDE:
                cases += [(f"C={MERGE_WIDE} b_count={bc}", MERGE_WIDE,
                           dict(mode=mode, bc=bc, b_at=at))
                          for mode, bc, at in (
                              ("few", MERGE_WIDE, None),
                              ("half", MERGE_WIDE // 2, None),
                              ("all", MERGE_WIDE, "before"))]
            for name, c, kw in cases:
                chk(f"K={K} N={n} {name}",
                    merge_inputs(torch, dev, rng, K, n, c, **kw), ref=ref)
    return chk, timed


def time_sorted_merge(torch, timed):
    """Per-launch times (``_per_launch_ms``) of the kernel and its plain
    version on the kept map-fill input, each call into its own output
    pair, and the kernel's at keep-none and empty A.  The bound counts the
    bytes the function needs once each (the one-byte keep of every A
    slot, key and value of the kept slots only, the B run and b_count;
    both outputs) over 3.35 TB/s, against a keep test per slot and a
    binary search of the B run per kept slot over 67 TOP/s."""
    from repro_torch.kernels.sorted_merge import (merge_compact_plain,
                                                  merge_compact_sharded)

    ak, av, keep, bk, bv, bc = inputs = timed["fill"]
    K, n = ak.shape
    c = bk.shape[1]
    zero = torch.zeros((2, K, n), dtype=torch.float32, device=ak.device)
    ring = [torch.empty_like(zero) for _ in range(RING)]

    def kernel(inp):
        return lambda r: merge_compact_sharded(*inp, out=(r[0], r[1]))

    out = {
        "ms": _per_launch_ms(torch, kernel(inputs), ring, zero, hold=True),
        "plain_ms": _per_launch_ms(torch, lambda r: merge_compact_plain(
            ak, av, keep, bk, bv, bc, out=(r[0], r[1])), ring[:PLAIN_RING],
            zero, hold=False),
        "none_ms": _per_launch_ms(torch, kernel(timed["none"]), ring, zero,
                                  hold=True),
        "empty_ms": _per_launch_ms(torch, kernel(timed["empty"]), ring,
                                   zero, hold=True),
        "library_ms": None, "K": K, "n": n, "c": c,
        "kept": int(keep.sum()), "b_count": int(bc.sum()),
    }
    del ring
    byte_ms = (K * n + 8 * out["kept"] + 8 * K * c + 4 * K + 8 * K * n) \
        / HBM_BYTES_PER_S * 1e3
    op_ms = (K * n + out["kept"] * (int(math.log2(c)) + 2)) \
        / F32_OPS_PER_S * 1e3
    out["bound_ms"] = max(byte_ms, op_ms)
    out["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    return out


def merge_line(chk, t, seconds, sizes):
    """The ``kernels: sorted_merge`` line of phase 9 (and ``--merge``)."""
    return (f"kernels: sorted_merge == plain on {chk.calls} launches "
            f"(max_abs_err {chk.max_abs_err}; N = "
            f"{', '.join(map(str, sizes))}, K = 4 and 1, C = {C_MAX} and "
            f"{MERGE_WIDE}; {seconds:.1f} s); " + (
                "timing not measured" if not t else
                f"ms {t['ms']:.6f} (K {t['K']}, N {t['n']}, C {t['c']}, "
                f"kept {t['kept']}, b_count {t['b_count']}; keep-none "
                f"{t['none_ms']:.6f}, empty A {t['empty_ms']:.6f}) "
                f"plain_ms {t['plain_ms']:.6f} bound_ms "
                f"{t['bound_ms']:.3e} ({t['bound_by']}) library_ms None "
                f"(no single PyTorch call merges a masked sorted run with "
                f"a sorted insert run)"))


# ---------------------------------------------------------------------------
# the ordered map and the counting sketch under 8 client threads
# ---------------------------------------------------------------------------
def grid_keys(rng, n):
    """``bench_map._items``' keys: n distinct f32 keys drawn from a
    linspace grid of 8n points over [0, 1000)."""
    grid = np.linspace(MAP_KEY_RANGE[0], MAP_KEY_RANGE[1], 8 * n,
                       endpoint=False).astype(np.float32)
    return rng.choice(grid, n, replace=False)


def map_op(r, known, n):
    """One op of ``bench_map._draw_op`` at c = READ_PCT: reads (lookup of
    a known key, kth_smallest, range_count / range_sum over 50-wide
    ranges) or updates (fresh insert, assign / delete of a known key)."""
    p = r.random() * 100
    if p < READ_PCT:
        q = int(r.integers(0, 4))
        if q == 0:
            return "lookup", float(known[r.integers(len(known))])
        if q == 1:
            return "kth_smallest", int(r.integers(1, n))
        lo = float(np.float32(r.uniform(0, MAP_KEY_RANGE[1] - 50)))
        return ("range_count" if q == 2 else "range_sum"), (lo, lo + 50.0)
    q = int(r.integers(0, 3))
    if q == 0:
        return "insert", (float(np.float32(r.uniform(*MAP_KEY_RANGE))),
                          float(np.float32(r.uniform(0, 10))))
    if q == 1:
        return "assign", (float(known[r.integers(len(known))]),
                          float(np.float32(r.uniform(0, 10))))
    return "delete", float(known[r.integers(len(known))])


def sketch_op(r, known):
    """One op of bench_sketch's mix at c = READ_PCT: count (known key) /
    total / distinct / topk, or an add (70% a known key)."""
    if r.random() * 100 < READ_PCT:
        q = int(r.integers(0, 4))
        if q == 0:
            return "count", float(known[r.integers(len(known))])
        if q == 3:
            return "topk", int(r.integers(1, 8))
        return ("total" if q == 1 else "distinct"), None
    if r.random() < 0.7:
        key = float(known[r.integers(len(known))])
    else:
        key = float(np.float32(r.uniform(*MAP_KEY_RANGE)))
    return "add", (key, float(int(r.integers(1, 10))))


def check_shards(name, state, route):
    """Every shard strictly ascending in [0, size), finite there, +inf
    (keys and values) past it and in the scratch slot, and routed to
    itself by ``route(keys) -> shard ids``."""
    keys, vals, size = (t.cpu().numpy() for t in state)
    for k in range(keys.shape[0]):
        n = int(size[k])
        body = keys[k, :n]
        check(np.all(np.isfinite(body)) and np.all(np.diff(body) > 0),
              f"{name}: shard {k} keys not finite and strictly ascending")
        check(np.all(np.isposinf(keys[k, n:]))
              and np.all(np.isposinf(vals[k, n:])),
              f"{name}: shard {k} not (+inf, +inf) past its size")
        check(np.all(route(body) == k), f"{name}: shard {k} holds keys "
                                        f"routed elsewhere")


def _states_bit_equal(torch, a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _replay_pair(torch, make, ds):
    """Two copies of ``ds`` (a map or a sketch) from its state: the kernel
    pass, and the plain pass through the ``_merge`` seam."""
    from repro_torch.kernels.sorted_merge import merge_compact_plain

    pair = []
    for plain in (False, True):
        h = make()
        h.state = type(ds.state)(*(t.clone() for t in ds.state))
        h._refresh_sizes(ds.state.size.cpu().numpy())
        if plain:
            h._merge = merge_compact_plain
        pair.append(h)
    return pair


def map_replay(torch, m, n_replay, seed, worst):
    """Seeded single-thread batches (the registry's update and read mixes,
    every 5th wider than c_max) through the kernel pass and the plain
    pass on clones of ``m``'s state: every ``MapState`` field bit-equal
    after each batch, answers equal to ``SequentialSortedMap``
    (``range_sum`` by :func:`range_sum_check`, its errors kept in
    ``worst``); on the card every 10th batch runs under
    :func:`one_fetch`."""
    from repro_torch.core import batched_map as bm
    from repro_torch.core.seq_map import SequentialSortedMap

    rng = np.random.default_rng([seed, 13])
    mk, mp = _replay_pair(torch, lambda: bm.ShardedMap(
        m.capacity, m.c_max, n_shards=m.n_shards, key_range=m.key_range,
        device=m.device), m)
    oracle = SequentialSortedMap(m.items())
    live = oracle._keys
    ctx = {"keys": [live[i] for i in rng.choice(len(live), 64,
                                                replace=False)]}
    for b in range(n_replay):
        k = int(rng.integers(2 * C_MAX + 1, 3 * C_MAX + 1)) if b % 5 == 4 \
            else int(rng.integers(1, C_MAX + 1))
        ms, ins = bm._gen_update(rng, k, ctx)
        qm, qi = bm._gen_read(rng, int(rng.integers(1, 9)), ctx)
        if b % 10 == 0 and m.device.type == "cuda":
            hk, ak = one_fetch(torch, bm, lambda: (
                mk.update_batch_async(ms, ins), mk.read_batch(qm, qi)))
        else:
            hk = mk.update_batch_async(ms, ins)
            ak = mk.read_batch(qm, qi)
        hp = mp.update_batch_async(ms, ins)
        ap = mp.read_batch(qm, qi)
        check(_states_bit_equal(torch, mk.state, mp.state),
              f"map replay batch {b}: kernel state != plain state")
        rk = hk.result()
        want = [oracle.apply(x, y) for x, y in zip(ms, ins)]
        check(rk == hp.result() == want,
              f"map replay batch {b}: updates {rk} != oracle {want}")
        check(ak == ap, f"map replay batch {b}: kernel reads != plain")
        scale = prefix_scale(mk.state) if "range_sum" in qm else None
        range_sum_check(qm, qi, ak, oracle.read_batch(qm, qi), worst,
                        f"map replay batch {b}", scale)
    check(mk.items() == oracle.items(), "map replay: final contents != "
                                        "oracle")
    return n_replay, mk, oracle


def prefix_scale(state):
    """``(lo, hi) -> P``: the magnitude of the f32 prefix sums a
    ``range_sum`` answer is a difference of.  Per key-range shard the
    read pass answers ``ps[hi] - ps[lo]`` with ``ps`` the shard's prefix
    sums; P adds, over the shards the range touches, the float64 sums of
    |value| up to both ends, from the map's state (one copy to the host;
    the replay holds that state to the oracle's contents)."""
    keys, vals, size = (t.cpu().numpy() for t in state)
    rows = []
    for k in range(keys.shape[0]):
        n = int(size[k])
        rows.append((keys[k, :n], np.concatenate([[0.0], np.cumsum(
            np.abs(vals[k, :n].astype(np.float64)))])))

    def scale(lo, hi):
        p = 0.0
        for ks, cum in rows:
            i = np.searchsorted(ks, np.float32(lo), side="left")
            j = np.searchsorted(ks, np.float32(hi), side="right")
            if j > i:
                p += cum[j] + cum[i]
        return p

    return scale


def range_sum_check(methods, inputs, got, want, worst, where, scale):
    """Every answer equal to the oracle's except ``range_sum``, a
    difference of f32 prefix sums whose error grows with the prefix
    sums, not with the answer.  It is held to
    ``1e-3 + RANGE_SUM_EPS · eps_f32 · P`` (P from :func:`prefix_scale`),
    and measured against the reference's own tolerance
    ``1e-3 + 1e-5·|want|`` without failing on it: ``worst`` keeps the
    worst absolute error, the worst error/tolerance, the worst
    error/(eps_f32·P) and the count of answers outside the reference's
    tolerance."""
    for m, i, g, w in zip(methods, inputs, got, want):
        if m != "range_sum":
            check(g == w, f"{where}: {m} {g} != oracle {w}")
            continue
        err = abs(g - w)
        ref_tol = 1e-3 + 1e-5 * abs(w)
        p = scale(*i)
        tol = 1e-3 + RANGE_SUM_EPS * F32_EPS * p
        worst["n"] += 1
        worst["over_ref"] += err > ref_tol
        if err > worst["abs"]:
            worst.update(abs=err, at=w)
        worst["ratio"] = max(worst["ratio"], err / ref_tol)
        worst["eps_p"] = max(worst["eps_p"], err / (F32_EPS * max(p, 1.0)))
        check(err <= tol, f"{where}: range_sum {g} vs oracle {w}: error "
                          f"{err} over 1e-3 + {RANGE_SUM_EPS} eps_f32 * "
                          f"prefix magnitude {p} = {tol}")


def range_sum_exact_probes(m, oracle, key_range, where):
    """``range_sum`` over narrow ranges at the low end of every key-range
    shard, where the shard's prefix sums stay in the thousands: there a
    difference of f32 prefix sums resolves every key, and the answers
    are held to the reference's own tolerance ``1e-3 + 1e-5·|want|``,
    so a dropped or double-counted key fails.  Returns (probes, worst
    error)."""
    lo0, hi0 = key_range
    width = (hi0 - lo0) / m.n_shards
    qi = [tuple(np.float32([lo0 + k * width + 0.05 * i,
                            lo0 + k * width + 0.05 * (i + 1)]).tolist())
          for k in range(m.n_shards) for i in range(8)]
    qm = ["range_sum"] * len(qi)
    got, want = m.read_batch(qm, qi), oracle.read_batch(qm, qi)
    worst = 0.0
    for (lo, hi), g, w in zip(qi, got, want):
        err = abs(g - w)
        worst = max(worst, err)
        check(err <= 1e-3 + 1e-5 * abs(w),
              f"{where}: range_sum over [{lo}, {hi}] {g} vs oracle {w}: "
              f"error {err} over the reference's tolerance")
    return len(qi), worst


def map_phase(torch, dev, seed, n, threads, ops, n_replay, counters):
    from repro_torch.core.pc_map import pc_megapass_map, pc_sharded_map
    from repro_torch.core.sharded_pq import route_range_host

    rng = np.random.default_rng([seed, 15])
    keys = grid_keys(rng, n)
    vals = rng.uniform(0, 10, n).astype(np.float32)
    items = list(zip(keys.tolist(), vals.tolist()))
    cap = shard_capacity(n + threads * ops + 2, 4)
    t0 = time.perf_counter()
    engine = pc_sharded_map(cap, C_MAX, n_shards=4, key_range=MAP_KEY_RANGE,
                            items=items, device=dev)
    m = engine.ds
    size0 = len(m)
    check(size0 == n, f"map: {size0} keys loaded, want {n}")
    setup_s = time.perf_counter() - t0
    def draw(r):
        return map_op(r, keys, n)

    (logs, seconds), launches = counted(
        torch, dev, "map", counters, ("sorted_merge",),
        lambda: drive_mixed(engine, threads, ops, seed, draw))
    done = [(mt, res) for log in logs for mt, _, res in log]
    ins = sum(1 for mt, res in done if mt == "insert" and res)
    dels = sum(1 for mt, res in done if mt == "delete" and res)
    check(size0 + ins - dels == len(m),
          f"map: size {len(m)} != {size0} + {ins} inserts - {dels} deletes")
    check_shards("map", m.state, lambda b: route_range_host(
        b, 4, *MAP_KEY_RANGE))
    n_ops = threads * ops
    stats = {
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "host_ms_per_pass": seconds / engine.passes * 1e3,
        "launches": launches, "setup_s": setup_s, "capacity": cap,
        "inserted": ins, "deleted": dels, "final_size": len(m),
        "device_bytes": sum(t.numel() * t.element_size() for t in m.state),
    }
    worst = {"n": 0, "abs": 0.0, "at": None, "ratio": 0.0, "over_ref": 0,
             "eps_p": 0.0}
    t0 = time.perf_counter()
    stats["replayed"], mk, oracle = map_replay(torch, m, n_replay, seed,
                                               worst)
    stats["replay_s"] = time.perf_counter() - t0
    # range_sum at the full key count: the threaded mix's 50-wide ranges
    # and wider ones, against the float64 sums of the oracle
    r = np.random.default_rng([seed, 16])
    qi = [(lo, lo + 50.0) for lo in
          np.float32(r.uniform(0, MAP_KEY_RANGE[1] - 50, 200)).tolist()]
    qi += [(0.0, float(hi)) for hi in
           np.float32(r.uniform(0, MAP_KEY_RANGE[1], 20)).tolist()]
    qi += [MAP_KEY_RANGE]
    qm = ["range_sum"] * len(qi)
    range_sum_check(qm, qi, mk.read_batch(qm, qi), oracle.read_batch(qm, qi),
                    worst, "map range_sum probe", prefix_scale(mk.state))
    worst["exact_probes"], worst["exact_worst"] = range_sum_exact_probes(
        mk, oracle, m.key_range, "map range_sum exact probe")
    stats["range_sum"] = worst
    # the megapass engine against its alternating twin, one client
    r = np.random.default_rng([seed, 17])
    ops_mp = [draw(r) for _ in range(400)]
    answers, states = [], []
    for use in (True, False):
        eng = pc_megapass_map(cap, C_MAX, n_shards=4,
                              key_range=MAP_KEY_RANGE, items=items,
                              device=dev, use_megapass=use)
        futs = [eng.submit(mt, i) for mt, i in ops_mp]
        answers.append([f.result() for f in futs])
        eng.close()
        states.append(eng.ds.state)
        if use:
            stats["megapass"] = {"dispatches": eng.megapass_dispatches,
                                 "rounds": eng.megapass_rounds}
    check(answers[0] == answers[1], "map: megapass answers != alternating")
    check(_states_bit_equal(torch, *states),
          "map: megapass state != alternating state")
    return stats



def sketch_replay(torch, s, n_replay, seed):
    """Seeded single-thread add and read batches (the registry's mixes,
    every 5th wider than c_max) through the kernel pass and the plain pass
    on clones of ``s``'s state: every ``SketchState`` field bit-equal
    after each batch, answers equal to ``SequentialSketch``; on the card
    every 10th batch runs under :func:`one_fetch`."""
    from repro_torch.core import batched_sketch as bs
    from repro_torch.core.seq_sketch import SequentialSketch

    rng = np.random.default_rng([seed, 18])
    sk, sp = _replay_pair(torch, lambda: bs.ShardedSketch(
        s.capacity, s.c_max, n_shards=s.n_shards, topk_max=s.topk_max,
        device=s.device), s)
    oracle = SequentialSketch(s.counters())
    live = list(oracle._c)
    ctx = {"keys": [live[i] for i in rng.choice(len(live), 64,
                                                replace=False)]}
    for b in range(n_replay):
        k = int(rng.integers(2 * C_MAX + 1, 3 * C_MAX + 1)) if b % 5 == 4 \
            else int(rng.integers(1, C_MAX + 1))
        ms, ins = bs._gen_update(rng, k, ctx)
        qm, qi = bs._gen_read(rng, int(rng.integers(1, 9)), ctx)
        if b % 10 == 0 and s.device.type == "cuda":
            hk, ak = one_fetch(torch, bs, lambda: (
                sk.update_batch_async(ms, ins), sk.read_batch(qm, qi)))
        else:
            hk = sk.update_batch_async(ms, ins)
            ak = sk.read_batch(qm, qi)
        hp = sp.update_batch_async(ms, ins)
        ap = sp.read_batch(qm, qi)
        check(_states_bit_equal(torch, sk.state, sp.state),
              f"sketch replay batch {b}: kernel state != plain state")
        rk = hk.result()
        want = [oracle.apply(x, y) for x, y in zip(ms, ins)]
        check(rk == hp.result() == want,
              f"sketch replay batch {b}: adds {rk} != oracle {want}")
        wr = oracle.read_batch(qm, qi)
        check(ak == ap == wr,
              f"sketch replay batch {b}: reads {ak} != oracle {wr}")
    check(sk.counters() == oracle.items(),
          "sketch replay: final counters != oracle")
    return n_replay


def sketch_phase(torch, dev, seed, n, threads, ops, n_replay, counters):
    from repro_torch.core.pc_sketch import pc_sharded_sketch
    from repro_torch.core.sharded_pq import route_hash_host

    rng = np.random.default_rng([seed, 19])
    keys = grid_keys(rng, n)
    weights = rng.integers(1, 10, n)
    items = list(zip(keys.tolist(), weights.astype(float).tolist()))
    total0 = int(weights.sum())
    # exactness precondition: every partial sum of integer-valued f32
    # counts stays below 2^24 (at most 9 per add)
    check(total0 + 9 * threads * ops < 2 ** 24,
          f"sketch: {total0} + adds could reach 2^24")
    cap = shard_capacity(n + threads * ops + 2, 4)
    t0 = time.perf_counter()
    engine = pc_sharded_sketch(cap, C_MAX, n_shards=4, topk_max=TOPK_MAX,
                               items=items, device=dev)
    s = engine.ds
    setup_s = time.perf_counter() - t0
    check(s.read_batch(["total", "distinct"], [None, None])
          == [float(total0), n], "sketch: prepopulated totals differ")
    def draw(r):
        return sketch_op(r, keys)

    (logs, seconds), launches = counted(
        torch, dev, "sketch", counters, ("sorted_merge",),
        lambda: drive_mixed(engine, threads, ops, seed, draw))
    adds = [(i, res) for log in logs for mt, i, res in log if mt == "add"]
    added = sum(int(w) for (_, w), _ in adds)
    created = sum(1 for _, res in adds if res)
    total, distinct = s.read_batch(["total", "distinct"], [None, None])
    check(total == total0 + added, f"sketch: total {total} != {total0} + "
                                   f"{added} added")
    check(distinct == n + created, f"sketch: distinct {distinct} != {n} + "
                                   f"{created} created")
    check(total < 2 ** 24, "sketch: total reached 2^24")
    check_shards("sketch", s.state, lambda b: route_hash_host(b, 4))
    n_ops = threads * ops
    t0 = time.perf_counter()
    replayed = sketch_replay(torch, s, n_replay, seed)
    return {
        "replayed": replayed, "replay_s": time.perf_counter() - t0,
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "host_ms_per_pass": seconds / engine.passes * 1e3,
        "launches": launches, "setup_s": setup_s, "capacity": cap,
        "adds": len(adds), "created": created, "total": total,
        "device_bytes": sum(t.numel() * t.element_size() for t in s.state),
    }


# ---------------------------------------------------------------------------
# the dense decoder: flash_attention and the model stack
# ---------------------------------------------------------------------------
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:57
# bf16 kernel against plain, row by row: ||got - want|| / ||want|| over
# each output row, 4 times bf16's 2^-8 (tests/test_torch_flash_attention.py
# ROW_TOL: a 64-key tile too many or too few at a long window edge fails it)
ATTN_ROW_TOL = 2 ** -6
BF16_OPS_PER_S = 989e12        # H100 SXM, dense bf16 tensor cores
# (B, Sq, Skv, H, K, hd, hd_v, causal, window, cap, q_offset, kv_len): the
# CPU tests' cases (tests/test_torch_flash_attention.py), each run in f32
# and in bf16; kv_len None means Skv
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, 64, True, 0, 0.0, 0, None),
    (1, 64, 64, 4, 4, 32, 32, True, 0, 50.0, 0, None),
    (2, 64, 256, 8, 2, 64, 64, False, 0, 0.0, 0, None),
    (1, 256, 256, 4, 1, 64, 64, True, 64, 0.0, 0, None),
    (1, 96, 96, 2, 2, 16, 16, True, 32, 30.0, 0, None),
    (1, 33, 65, 2, 1, 8, 8, True, 0, 0.0, 0, None),
    (1, 8, 32, 2, 2, 16, 16, True, 0, 0.0, 24, None),         # q_offset
    (2, 40, 64, 4, 2, 16, 16, True, 0, 0.0, 24, 37),          # kv_len
    (2, 40, 64, 4, 2, 16, 16, False, 0, 0.0, 24, 37),
    (1, 48, 48, 4, 2, 16, 24, True, 0, 0.0, 0, None),         # hd_v != hd
    (1, 64, 64, 2, 1, 16, 16, True, 8, 30.0, 0, None),        # window < tile
    (1, 64, 104, 2, 1, 16, 16, True, 8, 30.0, 40, None),
    (2, 200, 200, 8, 4, 256, 256, True, 64, 50.0, 0, None),   # gemma2 heads
    (1, 130, 130, 4, 1, 80, 80, False, 0, 0.0, 0, None),      # hubert heads
    (1, 100, 100, 4, 2, 128, 128, True, 0, 0.0, 0, None),
    # the bf16 kernel's tile edges (128 query rows, 64 KV slots) at hd 64
    # and 256, head widths padded to an instance, hd_v != hd at MLA's
    # widths, and rows with no unmasked key in their first visited tile
    (1, 127, 127, 2, 1, 64, 64, True, 0, 0.0, 0, None),
    (1, 128, 128, 2, 1, 64, 64, True, 0, 0.0, 0, None),
    (1, 129, 129, 2, 1, 64, 64, True, 0, 0.0, 0, None),
    (1, 129, 127, 2, 1, 64, 64, False, 0, 0.0, 0, None),
    (1, 63, 63, 2, 1, 256, 256, True, 0, 50.0, 0, None),
    (1, 64, 64, 2, 1, 256, 256, True, 0, 0.0, 0, None),
    (1, 65, 65, 2, 1, 256, 256, True, 16, 0.0, 0, None),
    (1, 129, 129, 2, 1, 256, 256, True, 0, 0.0, 0, None),
    (2, 70, 70, 4, 2, 24, 24, True, 0, 0.0, 0, None),
    (1, 150, 150, 2, 1, 192, 128, True, 0, 0.0, 0, None),
    (1, 200, 264, 2, 1, 64, 64, True, 24, 30.0, 64, None),
]
MODEL_ARCH = "qwen2_0_5b"      # serve.py's default --arch, full width
MODEL_BATCH = 4                # scoring: 4 x 4,096 tokens
MODEL_SEQ = 4096
SERVE_BATCH = 8                # DecodeExecutor(max_batch=8): 8 requests
SERVE_PROMPT = 512
SERVE_NEW = 32
GEMMA_ARCH = "gemma2_2b"       # full width, 2 layers (one local, one full)
GEMMA_LAYERS = 2
GEMMA_SEQ = 8192               # past the 4,096 window
GEMMA_BATCH = 2                # the attention phase's gemma2 shape
RG_WINDOW = 2048               # configs/recurrentgemma_2b.py's local window
LLAMA4_ARCH = "llama4_scout_17b_a16e"   # full width, 2 of its 48 layers
LLAMA4_LAYERS = 2
LLAMA4_BATCH = 2               # scoring: 2 x 4,096 tokens
DEEPSEEK_ARCH = "deepseek_v2_lite_16b"  # full width: the prefix + 7 MoE
DEEPSEEK_LAYERS = 8
DEEPSEEK_BATCH = 4             # scoring: 4 x 4,096 tokens
VISION_ARCH = "llama_3_2_vision_11b"    # full width, 2 periods of 5
VISION_LAYERS = 10
VISION_BATCH = 2               # scoring: 2 x 4,096 tokens
HUBERT_ARCH = "hubert_xlarge"  # full width and depth (48 layers)
HUBERT_BATCH = 8               # scoring: 8 x 1,500 frames (30 s at 20 ms)
HUBERT_FRAMES = 1500
EMBED_SCALE = 0.02             # frames, image embeddings: test_models.py:18-24
LOGIT_TOL = 2e-2               # of max|y|, one layer in bf16 (see scoring)
LOSS_TOL = 5e-3                # tests/test_models.py:164-165
F32_LOGIT_TOL = 1e-4           # of max|logit|, f32 weights and activations
NOISE_RATIO = 1.5              # a bf16 path's error against the f32
                               # forward, over the plain path's own


def attention_bound(B, Sq, Skv, H, K, hd, hd_v, causal, window, q_offset,
                    kv_len, itemsize):
    """The least time for one call: the unmasked (q, k) pairs these
    inputs need, 2 (hd + hd_v) FLOP each, over the peak for their type
    (bf16 tensor cores, else f32 outside them), against q, k, v read once
    and the output written once over 3.35 TB/s.  Returns (ms, by, FLOP,
    bytes)."""
    q_pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(kv_len - 1, q_pos) if causal else np.full(Sq, kv_len - 1)
    lo = np.maximum(0, q_pos - window + 1) if window else np.zeros(Sq)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    flop = 2 * (hd + hd_v) * pairs * B * H
    nbytes = itemsize * (B * Sq * H * (hd + hd_v) + B * Skv * K * (hd + hd_v))
    op_ms = flop / (BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms
            else "bytes", flop, nbytes)


def _per_call_ms(torch, fn, n, windows, hold):
    """Median over ``windows`` CUDA-event windows of ``n`` back-to-back
    calls, divided by ``n`` (window 0 warms up).  With ``hold`` a spin
    kernel keeps the stream busy while the host enqueues, so the window
    holds the device's time only; a window the device caught up with
    raises.  Without it (the plain version, host-bound) it is wall time."""
    times = []
    for w in range(windows + 1):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        t0.record()
        for _ in range(n):
            fn()
        caught_up = hold and t0.query()
        t1.record()
        t1.synchronize()
        if w:
            check(not caught_up, "timing: the device caught up with the "
                                 "host inside a held window")
            times.append(t0.elapsed_time(t1) / n)
    return float(np.median(times))


def attention_phase(torch, dev, seed, main_seq, gemma_seq, timing,
                    hubert_seq=HUBERT_FRAMES):
    """``flash_attention`` (the kernel on CUDA tensors) against
    ``flash_attention_plain`` with the kernel's own tiles, on every case of
    the CPU tests and at the five model shapes (Qwen2-0.5B's, gemma2's,
    RecurrentGemma's, HuBERT's, llama4's), in f32 and in bf16, within the
    reference's tolerances (atol = rtol = 2e-5 in f32, 2e-2 in bf16) and,
    in bf16, each output row within ATTN_ROW_TOL of its norm.  TF32 is off
    for the plain version's f32 products.  Then, at each model shape in
    bf16: the kernel's ms, the plain version's (the model's 128-wide
    tiles) and the bound; SDPA's as the library yardstick (never called by
    the port) at Qwen2's, HuBERT's and llama4's (SDPA takes no softcap or
    window: no yardstick at gemma2's or RecurrentGemma's)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import KERNEL_BLOCKS

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    main = (MODEL_BATCH, main_seq, main_seq, 14, 2, 64, 64, True, 0, 0.0, 0,
            None)
    gemma = (GEMMA_BATCH, gemma_seq, gemma_seq, 8, 4, 256, 256, True, 4096,
             50.0, 0, None)
    # RecurrentGemma's local layer: 10 query heads, one KV head of 256
    rg = (1, gemma_seq, gemma_seq, 10, 1, 256, 256, True, RG_WINDOW, 0.0, 0,
          None)
    # HuBERT's self-attention: 16 heads of 80, non-causal, 1,500 frames (not
    # a multiple of the tile); llama4's: a GQA group of 5 (40 / 8 heads)
    hubert = (HUBERT_BATCH, hubert_seq, hubert_seq, 16, 16, 80, 80, False, 0,
              0.0, 0, None)
    llama4 = (LLAMA4_BATCH, main_seq, main_seq, 40, 8, 128, 128, True, 0,
              0.0, 0, None)
    shapes = {"main": main, "gemma": gemma, "rg": rg, "hubert": hubert,
              "llama4": llama4}
    rec = {"checked": 0, "max_abs_err": 0.0,
           "max_abs_err_by_dtype": {"float32": 0.0, "bfloat16": 0.0},
           "max_row_err_bf16": 0.0}
    kept = {}
    for case in ATTN_CASES + list(shapes.values()):
        B, Sq, Skv, H, K, hd, hd_v, causal, window, cap, q_off, kv_len = case
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            blocks = KERNEL_BLOCKS[dt]
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(dt)
                       for s in ((B, Sq, H, hd), (B, Skv, K, hd),
                                 (B, Skv, K, hd_v)))
            kw = dict(causal=causal, window=window, cap=cap,
                      q_offset=q_off, kv_len=kv_len,
                      scale=256 ** -0.5 if case is gemma else None)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, block_q=blocks[0],
                                         block_k=blocks[1], **kw)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"flash_attention {case}: shape/dtype")
            g, w_ = got.float(), want.float()
            err = (g - w_).abs()
            tol = ATTN_TOL[dname]
            check(bool(torch.isfinite(g).all()),
                  f"flash_attention {case} {dname}: non-finite output")
            bad = int((err > tol + tol * w_.abs()).sum())
            e = float(err.max())
            check(bad == 0, f"flash_attention {case} {dname}: {bad} "
                            f"elements outside the tolerance, max_abs_err {e}")
            if dname == "bfloat16":
                row = float(((g - w_).norm(dim=-1) / w_.norm(dim=-1)).max())
                check(row <= ATTN_ROW_TOL, f"flash_attention {case} bf16: "
                      f"a row {row} off in norm (limit {ATTN_ROW_TOL})")
                rec["max_row_err_bf16"] = max(rec["max_row_err_bf16"], row)
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            rec["max_abs_err_by_dtype"][dname] = max(
                rec["max_abs_err_by_dtype"][dname], e)
            rec["checked"] += 1
            for which, shape in shapes.items():
                if case is shape and dname == "bfloat16":
                    kept[which] = (q, k, v, kw)
            del q, k, v, got, want, g, w_, err
    if dev.type == "cuda":
        # a bf16 layout the kernel does not take raises before any launch
        q = torch.zeros((1, 32, 2, 68), dtype=torch.bfloat16, device=dev)
        before = flash_attention.launches
        try:
            flash_attention(q[..., :64], q[..., :64], q[..., :64])
            refused = False
        except ValueError:
            refused = True
        check(refused and flash_attention.launches == before,
              "flash_attention took a bf16 head stride of 68 elements "
              "(not 16-byte aligned)")
    if not timing:
        return rec
    F = torch.nn.functional
    for which, n, n_plain in (("main", 30, 2), ("gemma", 10, 1),
                              ("rg", 10, 1), ("hubert", 10, 1),
                              ("llama4", 10, 1)):
        q, k, v, kw = kept[which]
        B, Sq, H, hd = q.shape
        _, Skv, K, hd_v = v.shape
        pre = "" if which == "main" else which + "_"
        rec[pre + "ms"] = _per_call_ms(
            torch, lambda: flash_attention(q, k, v, **kw), n, 5, hold=True)
        rec[pre + "plain_ms"] = _per_call_ms(
            torch, lambda: flash_attention_plain(q, k, v, block_q=128,
                                                 block_k=128, **kw),
            n_plain, 2, hold=False)
        bound, by, flop, nbytes = attention_bound(
            B, Sq, Skv, H, K, hd, hd_v, kw["causal"], kw["window"],
            kw["q_offset"], Skv, 2)
        rec[pre + "bound_ms"], rec[pre + "bound_by"] = bound, by
        rec[pre + "flop"], rec[pre + "bytes"] = flop, nbytes
        rec[pre + "shape"] = [B, Sq, H, K, hd, kw["window"], kw["cap"]]
        if which in ("main", "hubert", "llama4"):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            causal = kw["causal"]
            lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
            e = float((lib.transpose(1, 2).float()
                       - flash_attention(q, k, v, **kw).float()).abs().max())
            check(e <= ATTN_TOL["bfloat16"] * 4,
                  f"SDPA yardstick disagrees with the kernel by {e} at "
                  f"{which}")
            rec[pre + "library_ms"] = _per_call_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), n, 5,
                hold=True)
            rec[pre + "library_err"] = e
    return rec


def ptxas_report(log: str, cufilt: str):
    """(source, kernel, registers, spill store bytes, spill load bytes) of
    each entry function that ``ptxas -v`` reported in ``build.log``, its
    name demangled by the toolkit's ``cu++filt`` (at ``cufilt``) without
    its arguments or anonymous namespace."""
    import re

    rows, src, name, spill = [], None, None, (0, 0)
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln.split()[1]
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([src, name, int(m.group(1)), *spill])
            name, spill = None, (0, 0)
    names = subprocess.run(
        [cufilt, "-p"], input="\n".join(r[1] for r in rows),
        capture_output=True, text=True, check=True).stdout.splitlines()
    for r, n in zip(rows, names):
        for drop in ("(anonymous namespace)::", "<unnamed>::", "(int)"):
            n = n.replace(drop, "")
        r[1] = n.removeprefix("void ")
    return rows


def _model_cfg(arch, reduced, **kw):
    from repro_torch import configs

    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    return cfg.with_(**kw)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _logit_err(got, want, keep=None):
    """max|got − want| / max|want|, a batch row at a time (no full-size
    temporaries), over the positions ``keep`` (B, S) marks (all without
    it); returns (that, max|want|)."""
    err = scale = 0.0
    for b in range(want.shape[0]):
        e = (got[b].float() - want[b]).abs().amax(-1)
        s = want[b].abs().amax(-1)
        if keep is not None:
            e, s = e[keep[b]], s[keep[b]]
        if not e.numel():
            continue
        err = max(err, float(e.max()))
        scale = max(scale, float(s.max()))
    return (err / scale if scale else 0.0), scale


def _upcast(tree):
    """The parameter tree (or a batch's embeddings) in f32 (bf16 → f32 is
    exact); integer leaves as they are."""
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_upcast(v) for v in tree)
    return tree.float() if tree.is_floating_point() else tree


def _f32_cfg(cfg):
    """The config the f32 model runs under: the MoE's products with f32
    accumulators (``moe_bf16_dispatch`` off), as the CPU tests hold them
    (tests/test_torch_families.py): llama4's bf16 accumulators round the
    expert outputs to bf16, which is not an f32 model."""
    return cfg.with_(moe_bf16_dispatch=False) if cfg.moe else cfg


@contextlib.contextmanager
def plain_scans(exact=False):
    """The recurrent mixers' seam (``models.recurrent.SCANS``) pointed at
    the plain scans for the block's duration: the plain path the kernel
    path is held against (restored after, whatever happens).  With
    ``exact``, the exact step-by-step scans of ``linear_scan/ref.py``
    instead: a second plain f32 path that differs from the first in its
    rounding only (see :func:`scoring`)."""
    from repro_torch.kernels.linear_scan import (rglru_scan_plain,
                                                 rwkv6_scan_plain)
    from repro_torch.kernels.linear_scan.ref import (rglru_reference,
                                                     rwkv6_reference)
    from repro_torch.models import recurrent

    saved = dict(recurrent.SCANS)
    if exact:
        recurrent.SCANS.update(
            rwkv6=lambda r, k, v, w, u, s0, **_: rwkv6_reference(
                r, k, v, w, u, s0),
            rglru=lambda a, b, h0, **_: rglru_reference(a, b, h0))
    else:
        recurrent.SCANS.update(rwkv6=rwkv6_scan_plain,
                               rglru=rglru_scan_plain)
    try:
        yield
    finally:
        recurrent.SCANS.update(saved)


@contextlib.contextmanager
def decay_probe(torch):
    """For the block's duration, record what the RWKV-6 mixers hand their
    scan: the largest sum of |log w| over a 64-token chunk (chunks from
    each sequence's start, per batch row, head and channel), the measure
    of the reference's chunked domain (below ~80).  Yields a dict whose
    "max" is that largest sum (None if no RWKV-6 scan ran)."""
    from repro_torch.models import recurrent

    seen = {"max": None}
    scan = recurrent.SCANS["rwkv6"]

    def probed(r, k, v, w, u, s0, **kw):
        B, S, H, hd = w.shape
        lw = -torch.log(w.float())
        lw = torch.nn.functional.pad(lw, (0, 0, 0, 0, 0, (-S) % 64))
        top = float(lw.reshape(B, -1, 64, H, hd).sum(2).max())
        seen["max"] = top if seen["max"] is None else max(seen["max"], top)
        return scan(r, k, v, w, u, s0, **kw)

    recurrent.SCANS["rwkv6"] = probed
    try:
        yield seen
    finally:
        recurrent.SCANS["rwkv6"] = scan


def head_positions(cfg):
    """The first positions whose f32 logits :func:`scoring` holds apart:
    n_layers + 32 with RWKV-6 layers (see there), else none."""
    return cfg.n_layers + 32 if per_forward(cfg)["rwkv6_scan"] else 0


def per_forward(cfg):
    """Hand-written kernel launches of one scoring forward: one
    ``flash_attention`` a self-attention layer (``attention_impl=
    "pallas"``; cross-attention and MLA attend outside the kernel, as in
    the reference), one ``rwkv6_scan`` an RWKV-6 layer, one ``rglru_scan``
    an RG-LRU layer."""
    specs = cfg.layer_specs
    return {"flash_attention": sum(s.mixer in ("full", "local")
                                   and not s.cross_attn for s in specs),
            "rwkv6_scan": sum(s.mixer == "rwkv6" for s in specs),
            "rglru_scan": sum(s.mixer == "rglru" for s in specs)}


def layer_check(torch, cfg, params, batch):
    """Teacher-forced, layer by layer along the kernel path: each layer's
    mixer output (attention, cross-attention, MLA, RWKV-6 time-mix or
    RG-LRU block; deepseek's prefix first) through the kernel and through
    the plain path (the blockwise attention, the plain scans) on the SAME
    bf16 input; returns the worst max|Δ| / max|y|."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import rmsnorm

    pallas = cfg.with_(attention_impl="pallas")
    plain = cfg.with_(attention_impl="xla_chunked")
    x = transformer.embed_input(params, cfg, batch)
    ctx = batch.get("image_embeds")
    pos = torch.arange(x.shape[1], device=x.device)
    per = cfg.period
    layers = [(params["prefix"], transformer._prefix_spec(cfg))] \
        if cfg.n_prefix else []
    layers += [(transformer._index(params["stack"][j], i), per[j])
               for i in range(cfg.n_full_periods) for j in range(len(per))]
    layers += [(params["rem"][j], per[j % len(per)])
               for j in range(cfg.n_remainder)]
    worst = 0.0
    for lp, lspec in layers:
        h = rmsnorm(lp["n1"], x)
        _, mixer = transformer._MIXERS[lspec.mixer]
        ya = mixer(lp["mixer"], pallas, lspec, h, positions=pos, ctx=ctx)
        with plain_scans():
            yb = mixer(lp["mixer"], plain, lspec, h, positions=pos, ctx=ctx)
        worst = max(worst, _logit_err(ya, yb.float())[0])
        x = transformer.block_apply(lp, pallas, lspec, x, positions=pos,
                                    ctx=ctx)
    return worst


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def device_rows(ka):
    """The rows of ``key_averages()`` that are device activities (kernels,
    copies).  The host ops' rows carry their kernels' device time as well
    (torch 2.11), so a sum over all rows counts it twice."""
    from torch.autograd import DeviceType

    return [e for e in ka if e.device_type == DeviceType.CUDA]


# the profiler's names of the hand-written kernels (their demangled
# signatures contain these): rwkv6_scan's two bodies, flash_attention's two
# kernels, rglru_scan's
PROFILED = {"rwkv6_scan": ("::chunk::kernel", "::step::kernel"),
            "flash_attention": ("::bf16::kernel", "::f32::kernel"),
            "rglru_scan": ("rglru_scan_kernel",),
            "rwkv6_scan_bwd": ("rwkv6_scan_bwd_kernel",),
            "rglru_scan_bwd": ("rglru_scan_bwd_kernel",)}


def profile_once(torch, one, top=5):
    """One call of ``one()`` (already warm) under torch.profiler: its wall
    time, the device time of all its kernels, the busy share, the kernel
    launches, the ``top`` device ops by device time, and each hand-written
    kernel's device time and launches (``PROFILED``) wherever it ranks."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    rows = device_rows(ka)
    dev_us = sum(e.self_device_time_total for e in rows)
    busiest = sorted(rows, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "busy_share": dev_us / 1e6 / wall,
            "launches": sum(e.count for e in ka if e.key in LAUNCH_CALLS),
            "top": [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                    for e in busiest],
            "ours": {name: (sum(e.self_device_time_total for e in mine) / 1e3,
                            sum(e.count for e in mine))
                     for name, keys in PROFILED.items()
                     for mine in [[e for e in rows
                                   if any(k in e.key for k in keys)]]
                     if mine}}


ROUTE_MARGIN = 1e-6            # top-k boundary margin a flip may sit under


def n_moe(cfg):
    """MoE FFN layers of one forward (deepseek's prefix is a GLU)."""
    return sum(s.ffn == "moe" for s in cfg.layer_specs)


@contextlib.contextmanager
def moe_probe(torch):
    """For the block's duration, record each MoE FFN call's routing (the
    model's ``moe.route`` and ``moe.dispatch`` wrapped): the chosen experts
    (G, T, K), the top-k boundary's margin (G, T) — the K-th largest
    router probability minus the (K+1)-th — each pick's keep flag (G, T,
    K), and the dropped and routed assignments.  Yields ``{"route":
    [(top_e, margin), ...], "keep": [...], "drop": [(dropped, routed),
    ...]}`` in call order (device tensors, no sync)."""
    from repro_torch.models import moe

    seen = {"route": [], "keep": [], "drop": []}
    route, dispatch = moe.route, moe.dispatch

    def probed_route(p, cfg, xt):
        top_p, top_e = route(p, cfg, xt)
        k = cfg.moe.top_k
        srt = torch.sort(moe.router_probs(p, xt), dim=-1,
                         descending=True).values
        seen["route"].append((top_e, srt[..., k - 1] - srt[..., k]))
        return top_p, top_e

    def probed_dispatch(top_e, n_experts, C):
        d = dispatch(top_e, n_experts, C)
        kept = torch.empty_like(d["keep"])
        kept.scatter_(-1, d["order"], d["keep"])     # back to (t, k) order
        seen["keep"].append(kept.reshape(top_e.shape))
        seen["drop"].append(((~d["keep"]).sum(), d["keep"].numel()))
        return d

    moe.route, moe.dispatch = probed_route, probed_dispatch
    try:
        yield seen
    finally:
        moe.route, moe.dispatch = route, dispatch


def drop_share(seen, calls=None):
    """The dropped share of the routed assignments of the recorded calls
    (a slice of them with ``calls``)."""
    d = seen["drop"] if calls is None else seen["drop"][calls]
    return sum(int(n) for n, _ in d) / max(sum(m for _, m in d), 1)


def routing(torch, seen, cfg, B):
    """Per MoE layer, (experts (B, P, K), margins (B, P), keep flags (B, P,
    K)) over the positions the recorded calls routed in order: a
    forward's one call a layer, or a serving call's prefill and then each
    decode step.  Each position's experts ascend (with their keep flags):
    the dispatch reads the set of a token's picks, not their order by
    probability, so two picks that swap ranks inside the top k are no
    flip."""
    L = n_moe(cfg)
    K = cfg.moe.top_k

    def cat(xs, tail):
        return torch.cat([x.reshape(B, -1, *tail) for x in xs], 1)

    out = []
    for j in range(L):
        e, at = cat([e for e, _ in seen["route"][j::L]], (K,)).sort(-1)
        out.append((e, cat([m for _, m in seen["route"][j::L]], ()),
                    cat(seen["keep"][j::L], (K,)).gather(-1, at)))
    return out


def route_compare(a, b):
    """Two runs' :func:`routing` over the same positions: (differ, bad,
    near, worst).  ``differ`` (B, P): routed to other experts, or kept and
    dropped otherwise (one token's flip moves the capacity boundary of two
    experts), in some layer; ``bad``: the first such layer picks other
    experts at a top-k margin (the smaller of the two runs') of at least
    ROUTE_MARGIN, a flip that rounding cannot explain; ``near``: some
    layer's margin under ROUTE_MARGIN; ``worst``: the largest margin at
    such a first flip (0.0 without one)."""
    differ = bad = near = None
    worst = 0.0
    for (ea, ma, ka), (eb, mb, kb) in zip(a, b):
        de = (ea != eb).any(-1)
        d = de | (ka != kb).any(-1)
        m = ma.minimum(mb)
        flip = de if differ is None else de & ~differ
        if bool(flip.any()):
            worst = max(worst, float(m[flip].max()))
        bad_l, near_l = flip & (m >= ROUTE_MARGIN), m < ROUTE_MARGIN
        differ = d if differ is None else differ | d
        bad = bad_l if bad is None else bad | bad_l
        near = near_l if near is None else near | near_l
    return differ, bad, near, worst


def from_first(mask):
    """(B, P) bool: each row's positions from its first True on (a token
    routed otherwise reaches the later positions through attention)."""
    return mask.int().cummax(dim=1).values.bool()


def scoring(torch, dev, name, cfg, params, batch, counters):
    """The scoring forward through the kernels: ``lm.loss_fn`` once to
    warm up, then — every count zeroed just before — ``lm.loss_fn`` and
    ``model_apply(mode="train")`` with ``attention_impl="pallas"`` on bf16
    weights over ``batch`` (tokens or frames, labels, image embeddings),
    each with :func:`per_forward`'s launches.  Then the checks (their
    launches outside the counted run):

    - the loss within LOSS_TOL of the plain path's (``"xla_chunked"``
      blockwise attention and the plain scans, :func:`plain_scans`, on the
      card);
    - every layer's mixer output, teacher-forced on the kernel path's
      bf16 inputs, within LOGIT_TOL of max|y| of the plain path's;
    - f32 weights (the bf16 ones upcast) and activations: the kernel
      path's logits within F32_LOGIT_TOL of max|logit| of the plain
      path's (the algorithm, end to end).  With RWKV-6 layers the f32
      forward is itself not that close to the truth at the first tokens:
      its per-head group norm rescales y = r·S to unit variance, and where
      r·k nearly cancels (position 1, with the initial u = 0:
      y = (r·k) v) a rounding of 1e-7 of Σ|r_i k_i| comes out at ~1e-4 and
      compounds over the layers.  Such a flip reaches later positions
      through the token shift, one position a layer, and through the
      state, which the init's decay (w ≈ 0.8 a step) shrinks below 1e-3
      in 32 steps: so the first :func:`head_positions` (n_layers + 32)
      positions are held apart, to the larger of F32_LOGIT_TOL and
      NOISE_RATIO times the distance there between the two plain f32
      paths, the chunked scans and the exact scans of ``ref.py``
      (``plain_scans(exact=True)``), and every later position to
      F32_LOGIT_TOL (of max|logit| over those positions);
    - bf16 end to end: the kernel path's error against that f32 forward
      at most NOISE_RATIO times the plain path's own (the bf16 drift of
      both, and between them, is printed), over the positions from
      :func:`head_positions` on.  For the 32-layer random RWKV-6 both
      paths sit ~0.76 of max|logit| off over the whole sequence (the group
      norm's flips at bf16 rounding, at its first tokens), so a check over
      every position held nothing there; the first positions' errors of
      both paths are printed apart.

    With MoE layers the routing is compared before the logits
    (:func:`moe_probe`): the f32 kernel path's chosen experts equal the
    f32 plain path's token by token, except where the first layer that
    differs has a top-k margin under ROUTE_MARGIN; such tokens (printed)
    leave the f32 logit check.  A router flip is another expert, not
    noise: the bf16 checks against the f32 forward keep only the
    positions whose tokens both bf16 paths routed as the f32 forward in
    every layer (the share left out is printed).  The f32 model runs the
    MoE with f32 accumulators (:func:`_f32_cfg`)."""
    from repro_torch.models import lm, transformer

    pallas = cfg.with_(attention_impl="pallas")
    plain = cfg.with_(attention_impl="xla_chunked")
    lm.loss_fn(params, pallas, batch)
    _sync(torch, dev)

    def drive():
        t0 = time.perf_counter()
        loss = lm.loss_fn(params, pallas, batch)
        _sync(torch, dev)
        t1 = time.perf_counter()
        logits, _ = transformer.model_apply(params, pallas, batch)
        _sync(torch, dev)
        return float(loss), logits, t1 - t0, time.perf_counter() - t1

    per_fwd = per_forward(cfg)
    (loss, logits, t_loss, t_fwd), launches = counted(
        torch, dev, name, counters, [k for k, n in per_fwd.items() if n],
        drive)
    if dev.type == "cuda":
        for k, n in per_fwd.items():
            check(launches[k] == 2 * n, f"{name}: {launches[k]} {k} "
                  f"launches in two forwards, want {n} each")
        if not any(per_fwd.values()):
            check(not any(launches.values()), f"{name}: a forward with no "
                  f"kernel layer launched {_nonzero(launches)}")
    B, S = batch["labels"].shape
    check(tuple(logits.shape) == (B, S, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{name}: logits of shape {tuple(logits.shape)} not finite")
    prof = None
    if dev.type == "cuda":
        prof = profile_once(torch, lambda: transformer.model_apply(
            params, pallas, batch))
    with plain_scans():
        ref_loss = float(lm.loss_fn(params, plain, batch))
    check(abs(loss - ref_loss) <= LOSS_TOL and math.isfinite(loss),
          f"{name}: loss {loss} vs the plain path's {ref_loss}")
    with decay_probe(torch) as decays:
        layer_err = layer_check(torch, cfg, params, batch)
    check(layer_err <= LOGIT_TOL, f"{name}: a layer's mixer output "
          f"differs from the plain path's by {layer_err:.3e} of max|y| "
          f"(limit {LOGIT_TOL})")
    p32, b32, c32 = _upcast(params), _upcast(batch), _f32_cfg(cfg)
    pallas32 = c32.with_(attention_impl="pallas")
    plain32 = c32.with_(attention_impl="xla_chunked")
    moe = n_moe(cfg) > 0
    with moe_probe(torch) as r_k16:
        if moe:
            transformer.model_apply(params, pallas, batch)
    with plain_scans(), moe_probe(torch) as r_p16:
        ref, _ = transformer.model_apply(params, plain, batch)
    with plain_scans(), moe_probe(torch) as r_t32:
        truth, _ = transformer.model_apply(p32, plain32, b32)
    head = head_positions(cfg)
    route = {}
    alike = None
    if moe:
        t32 = routing(torch, r_t32, cfg, B)
        d_k16 = route_compare(routing(torch, r_k16, cfg, B), t32)[0]
        d_p16 = route_compare(routing(torch, r_p16, cfg, B), t32)[0]
        alike = ~(d_k16 | d_p16)[:, head:]
        route.update(bf16_flipped=int(d_k16.sum()),
                     bf16_excluded=1.0 - float(alike.float().mean()),
                     drop=drop_share(r_k16), tokens=B * S)
    bf16_vs_plain, scale = _logit_err(logits, ref)
    kernel_noise = _logit_err(logits[:, head:], truth[:, head:], alike)[0]
    plain_noise = _logit_err(ref[:, head:], truth[:, head:], alike)[0]
    head_bf16 = None
    if head:            # (kernel path, plain path) at the first positions
        head_bf16 = (_logit_err(logits[:, :head], truth[:, :head])[0],
                     _logit_err(ref[:, :head], truth[:, :head])[0])
    del ref, logits
    with moe_probe(torch) as r_k32:
        got32, _ = transformer.model_apply(p32, pallas32, b32)
    keep32 = None
    if moe:
        differ, bad, near, worst = route_compare(
            routing(torch, r_k32, cfg, B), routing(torch, r_t32, cfg, B))
        check(not bool(bad.any()), f"{name}: f32 kernel path routed "
              f"{int(bad.sum())} tokens to other experts than the plain "
              f"path at a top-k margin of at least {ROUTE_MARGIN} (the "
              f"largest {worst:.3e})")
        keep32 = ~from_first(differ)[:, head:]
        route.update(f32_near=int(near.sum()), f32_flipped=int(differ.sum()),
                     f32_left_out=int((~keep32).sum()))
    del r_k16, r_p16, r_t32, r_k32
    f32_err = _logit_err(got32[:, head:], truth[:, head:], keep32)[0]
    head_err = head_noise = head_tol = f32_noise = None
    if head:
        head_err = _logit_err(got32[:, :head], truth[:, :head])[0]
    del got32
    if head:
        with plain_scans(exact=True):
            alt, _ = transformer.model_apply(p32, plain32, b32)
        f32_noise = _logit_err(alt[:, head:], truth[:, head:])[0]
        head_noise = _logit_err(alt[:, :head], truth[:, :head])[0]
        head_tol = max(F32_LOGIT_TOL, NOISE_RATIO * head_noise)
        del alt
    del truth, p32, b32
    check(f32_err <= F32_LOGIT_TOL, f"{name}: f32 kernel-path logits at "
          f"positions {head}.. differ from the plain path's by "
          f"{f32_err:.3e} of max|logit| (limit {F32_LOGIT_TOL:.0e}; the two "
          f"plain f32 paths: {f32_noise})")
    if head:
        check(head_err <= head_tol, f"{name}: f32 kernel-path logits at "
              f"positions 0-{head - 1} differ from the plain path's by "
              f"{head_err:.3e} of max|logit| (limit {head_tol:.3e}; the two "
              f"plain f32 paths: {head_noise:.3e})")
    check(kernel_noise <= NOISE_RATIO * plain_noise,
          f"{name}: bf16 kernel path {kernel_noise:.3e} off the f32 "
          f"forward at positions {head}.., over {NOISE_RATIO}x the plain "
          f"path's {plain_noise:.3e}")
    return {"launches": launches, "per_forward": per_fwd,
            "loss": loss, "plain_loss": ref_loss, "layer_err": layer_err,
            "f32_err": f32_err, "f32_noise": f32_noise, "head": head,
            "head_err": head_err, "head_noise": head_noise,
            "head_tol": head_tol, "head_bf16": head_bf16,
            "bf16_vs_plain": bf16_vs_plain,
            "kernel_noise": kernel_noise, "plain_noise": plain_noise,
            "max_logit": scale, "loss_s": t_loss, "forward_s": t_fwd,
            "profile": prof, "decay_chunk_max": decays["max"],
            "routing": route, "tokens_per_s": B * S / t_loss}


def _step_err_list(steps, fwd, first, keep=None):
    """max|step − fwd[:, pos]| / max|fwd[:, pos]| of each kept step's
    logits, step t at position first + t, over the batch rows ``keep``
    (B, P) marks at that position (a step with none kept is skipped)."""
    errs = []
    for t, s in enumerate(steps):
        rows = None if keep is None else keep[:, first + t][:, None]
        if rows is not None and not bool(rows.any()):
            continue
        errs.append(_logit_err(s[:, None], fwd[:, first + t][:, None],
                               rows)[0])
    return errs


def _step_errs(steps, fwd, first, keep=None):
    """The worst of :func:`_step_err_list`."""
    return max(_step_err_list(steps, fwd, first, keep))


def per_serve(cfg, new):
    """Hand-written kernel launches of a ``DecodeExecutor`` call that
    prefills and decodes ``new`` tokens: prefill runs every recurrent
    layer's scan once (attention prefills blockwise, no kernel); a decode
    step runs ``rwkv6_scan`` (S = 1) in every RWKV-6 layer, RG-LRU decodes
    by its one-step formula and attention by ``decode_attention``."""
    n = per_forward(cfg)
    return {"flash_attention": 0, "rwkv6_scan": n["rwkv6_scan"] * (1 + new),
            "rglru_scan": n["rglru_scan"]}


def _served(torch, dev, cfg, call, n, new, counters, name, timed):
    """Drive a serving ``call(n_tokens) -> (tokens (n, n_tokens), every
    step's logits, seconds)``: with ``timed``, a warm-up call and a timed
    prefill-only call (0 new tokens) first; then the full call, whose
    kernel launches are counted (every count zeroed just before) and held
    to :func:`per_serve` on the card.  Returns (tokens, step logits,
    prefill s, serving s, launches)."""
    t_prefill = None
    if timed:
        call(2)
        t_prefill = call(0)[2]
    want = per_serve(cfg, new)
    (gen, kept, t_serve), launches = counted(
        torch, dev, name, counters, [k for k, m in want.items() if m],
        lambda: call(new))
    if dev.type == "cuda":
        for k, m in want.items():
            check(launches[k] == m, f"{name}: {launches[k]} {k} launches "
                  f"in a serving call, want {m}")
    check(gen.shape == (n, new) and len(kept) == new + 1,
          f"serving: tokens {gen.shape}, {len(kept)} steps kept")
    return gen, kept, t_prefill, t_serve, launches


def serve(torch, dev, cfg, params, prompts, new, cache_dtype, counters,
          name, extra=None, timed=True):
    """``DecodeExecutor`` on ``prompts`` (one request each, ``new`` tokens
    a request), every step's logits kept, through :func:`_served`.  The
    executor feeds tokens only, as the reference's: ``extra`` must be
    empty.  Returns (tokens, prompts + tokens on the device, step logits,
    prefill s, serving s, device steps of the full call, launches)."""
    from repro_torch.launch.serve import DecodeExecutor

    check(not extra, "DecodeExecutor feeds tokens only")
    n, prompt = prompts.shape
    ex = DecodeExecutor(cfg.with_(attention_impl="pallas"), max_batch=n,
                        max_len=prompt + new, params=params, device=dev,
                        cache_dtype=cache_dtype, keep_logits=True)

    def call(n_tokens):
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = ex([{"prompt": p, "n_tokens": n_tokens} for p in prompts])
        _sync(torch, dev)
        return np.stack(out), ex.step_logits, time.perf_counter() - t0

    gen, kept, t_prefill, t_serve, launches = _served(
        torch, dev, cfg, call, n, new, counters, name, timed)
    full = torch.from_numpy(np.concatenate([prompts, gen], 1)).to(dev)
    return gen, full, kept, t_prefill, t_serve, 1 + new, launches


def serve_steps(torch, dev, cfg, params, prompts, new, cache_dtype,
                counters, name, extra=None, timed=True):
    """:func:`serve`'s contract through ``lm.make_prefill`` and
    ``lm.make_decode_step`` directly, for a model whose prefill takes more
    than tokens (the VLM's ``image_embeds`` in ``extra``), which the
    reference's executor cannot pass: one prefill of every prompt with
    ``extra``, then ``new`` greedy decode steps against the cache."""
    from repro_torch.models import lm, transformer

    n, prompt = prompts.shape
    pc = cfg.with_(attention_impl="pallas", decode_cache_len=prompt + new)
    prefill, decode = lm.make_prefill(pc), lm.make_decode_step(pc)
    tokens = torch.from_numpy(prompts).to(dev)

    def call(n_tokens):
        _sync(torch, dev)
        t0 = time.perf_counter()
        cache = transformer.init_cache(pc, n, prompt + new,
                                       dtype=cache_dtype, device=dev)
        logits, cache = prefill(params, {"tokens": tokens, **(extra or {})},
                                cache)
        kept = [logits]
        last = torch.argmax(logits, -1).to(torch.int32)[:, None]
        gen = []
        for t in range(n_tokens):
            gen.append(last[:, 0])
            nxt, step, cache = decode(params, cache, prompt + t, last)
            kept.append(step)
            last = nxt[:, None]
        out = (torch.stack(gen, 1).cpu().numpy() if gen else
               np.zeros((n, 0), np.int32))
        _sync(torch, dev)
        return out, kept, time.perf_counter() - t0

    gen, kept, t_prefill, t_serve, launches = _served(
        torch, dev, cfg, call, n, new, counters, name, timed)
    full = torch.from_numpy(np.concatenate([prompts, gen], 1)).to(dev)
    return gen, full, kept, t_prefill, t_serve, 1 + new, launches


def _embeds(torch, dev, rng, shape):
    """Seeded stand-in embeddings (HuBERT's frames, the VLM's image
    patches): N(0, 1) × EMBED_SCALE in bf16, as tests/test_models.py:18-24
    makes them."""
    return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(dev) * EMBED_SCALE).to(torch.bfloat16)


def model_inputs(torch, dev, cfg, rng, batch, seq):
    """A scoring batch of ``batch`` x ``seq``: tokens (frames for the
    audio frontend), labels, and the VLM's image embeddings, from
    ``rng``."""
    out = {}
    if cfg.audio_frontend:
        out["labels"] = torch.from_numpy(rng.integers(
            0, cfg.vocab, (batch, seq), dtype=np.int64)).to(dev)
        out["frames"] = _embeds(torch, dev, rng, (batch, seq, cfg.d_model))
    else:
        for k in ("tokens", "labels"):
            out[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab, (batch, seq), dtype=np.int64)).to(dev)
    if cfg.n_img_tokens:
        out["image_embeds"] = _embeds(torch, dev, rng,
                                      (batch, cfg.n_img_tokens, cfg.d_model))
    return out


def _with_capacity(cfg, factor):
    return cfg.with_(moe=dataclasses.replace(cfg.moe,
                                             capacity_factor=factor))


def model_phase(torch, dev, seed, counters, reduced=False,
                batch=MODEL_BATCH, seq=MODEL_SEQ, serve_batch=SERVE_BATCH,
                prompt=SERVE_PROMPT, new=SERVE_NEW, *, name="model",
                arch=MODEL_ARCH, n_layers=None, tag=14, prepare=None,
                keep=False, serving="executor"):
    """A model at full width (Qwen2-0.5B's 24 layers unless ``arch``
    and ``n_layers`` say otherwise), random bf16 weights from ``seed``
    (then ``prepare(params)``, if given): the scoring forward
    (:func:`scoring`) on batch x seq tokens (or frames, with the VLM's
    image embeddings), then, unless ``serving`` is None, serve_batch
    requests of ``prompt`` tokens and ``new`` new ones through
    ``DecodeExecutor(max_batch=serve_batch)`` (:func:`serve`; ``serving=
    "steps"``: ``make_prefill`` with the image embeddings and
    ``make_decode_step``, :func:`serve_steps`):

    - in bf16 (timed): every step's next-token logits (prefill's, then each
      decode step's) against the f32 forward over the same tokens at the
      same position at most NOISE_RATIO times as far off as the bf16
      kernel-path forward's; the drift against that bf16 forward and its
      greedy agreement are printed;
    - with f32 weights and an f32 cache: every step's logits within
      F32_LOGIT_TOL of max|logit| of the f32 kernel-path forward, and every
      greedy token equal to its argmax wherever its top-2 margin exceeds
      that tolerance.  This is the check that the state handed from
      prefill to decode (K/V, MLA's latents, the image K/V, the recurrent
      states, the conv and token-shift histories) is right.  With RWKV-6
      layers the limit is the larger of F32_LOGIT_TOL and NOISE_RATIO times
      the plain path's own distance, the f32 decode steps through the
      plain scans against the plain f32 forward over their tokens: the
      32-layer random model turns the GEMMs' shape-dependent roundings (8
      rows a decode step against 4,352 in the forward) into ~1e-4 of
      max|logit| at every position, the plain path's own steps included
      (see :func:`scoring`; both paths' medians and the steps over
      F32_LOGIT_TOL are printed).

    With MoE layers the bf16 serving is timed at the config's capacity
    factor, and the drop share of one decode step there printed (8
    tokens: llama4's C is 1, so decode drops what the forward keeps, the
    reference's GShard semantics); the checks above run at
    ``capacity_factor = n_experts`` (no drops, as the reference's own test,
    tests/test_models.py:97-99), on the positions whose tokens routed
    alike in the compared runs (:func:`moe_probe`; f32 flips only under
    ROUTE_MARGIN, as in :func:`scoring`).

    With ``keep`` the bf16 weights and the config stay in the returned
    stats under ``"keep"``, for the ``serve`` phase."""
    from repro_torch.launch.serve import DecodeExecutor
    from repro_torch.models import transformer

    cfg = _model_cfg(arch, reduced,
                     **({"n_layers": n_layers} if n_layers else {}))
    rng = np.random.default_rng([seed, tag])
    params = transformer.model_init(seed, cfg, device=dev)
    if prepare is not None:
        prepare(torch, params, seed)
    n_params = transformer.count_params(params)
    inputs = model_inputs(torch, dev, cfg, rng, batch, seq)
    s = scoring(torch, dev, name, cfg, params, inputs, counters)
    del inputs
    s["params"] = n_params
    if serving is None:
        return s

    moe = n_moe(cfg) > 0
    run = serve if serving == "executor" else serve_steps
    prompts = rng.integers(0, cfg.vocab, (serve_batch, prompt),
                           dtype=np.int64).astype(np.int32)
    extra = {}
    if cfg.n_img_tokens:
        extra["image_embeds"] = _embeds(
            torch, dev, rng, (serve_batch, cfg.n_img_tokens, cfg.d_model))
    gen, full, steps, t_prefill, t_serve, n_steps, served = run(
        torch, dev, cfg, params, prompts, new, torch.bfloat16, counters,
        name, extra)
    s["serve_launches"] = served
    s["launches"] = {k: n + served[k] for k, n in s["launches"].items()}
    chk = cfg
    if moe:
        ex = DecodeExecutor(cfg.with_(attention_impl="pallas"),
                            max_batch=serve_batch, max_len=prompt + 1,
                            params=params, device=dev)
        with moe_probe(torch) as seen:
            ex([{"prompt": q, "n_tokens": 1} for q in prompts])
        L = n_moe(cfg)
        s["routing"].update(decode_drop=drop_share(seen, slice(L, 2 * L)),
                            decode_tokens=serve_batch)
        del ex, seen
        # the checks: no capacity drops, so decode and forward agree
        chk = _with_capacity(cfg, float(cfg.moe.n_experts))
        with moe_probe(torch) as r_s16:
            gen, full, steps = run(torch, dev, chk, params, prompts, new,
                                   torch.bfloat16, counters, name, extra,
                                   timed=False)[:3]
    pallas = chk.with_(attention_impl="pallas")
    c32 = _f32_cfg(chk).with_(attention_impl="pallas")
    p32, x32 = _upcast(params), _upcast(extra)
    B = serve_batch
    with moe_probe(torch) as r_f16:
        fwd, _ = transformer.model_apply(params, pallas,
                                         {"tokens": full, **extra})
    with moe_probe(torch) as r_t32:
        truth, _ = transformer.model_apply(p32, c32, {"tokens": full, **x32})
    alike = None
    if moe:
        t32 = routing(torch, r_t32, cfg, B)
        alike = ~(route_compare(routing(torch, r_s16, cfg, B), t32)[0]
                  | route_compare(routing(torch, r_f16, cfg, B), t32)[0])
        s["routing"]["serve_bf16_excluded"] = int((~alike).sum())
        del r_s16
    del r_f16, r_t32
    drift = _step_errs(steps, fwd, prompt - 1)
    step_noise = _step_errs(steps, truth, prompt - 1, alike)
    fwd_noise = _step_errs([fwd[:, prompt - 1 + t]
                            for t in range(new + 1)], truth, prompt - 1,
                           alike)
    agree = int((gen == fwd[:, prompt - 1:prompt - 1 + new].argmax(-1)
                 .cpu().numpy()).sum())
    del fwd, truth, steps
    check(step_noise <= NOISE_RATIO * fwd_noise,
          f"serving: bf16 step logits {step_noise:.3e} off the f32 "
          f"forward, {NOISE_RATIO}x the bf16 forward's {fwd_noise:.3e}")

    with moe_probe(torch) as r_s32:
        gen32, full32, steps32 = run(torch, dev, _f32_cfg(chk), p32,
                                     prompts, new, torch.float32, counters,
                                     name, x32, timed=False)[:3]
    with moe_probe(torch) as r_f32:
        fwd32, _ = transformer.model_apply(p32, c32,
                                           {"tokens": full32, **x32})
    keep32 = None
    if moe:
        differ, bad, near, worst = route_compare(
            routing(torch, r_s32, cfg, B), routing(torch, r_f32, cfg, B))
        check(not bool(bad.any()), f"serving f32: {int(bad.sum())} decode "
              f"tokens routed to other experts than the forward's at a "
              f"top-k margin of at least {ROUTE_MARGIN} (the largest "
              f"{worst:.3e})")
        keep32 = ~from_first(differ)
        s["routing"].update(serve_f32_near=int(near.sum()),
                            serve_f32_flipped=int(differ.sum()),
                            serve_f32_worst=worst,
                            serve_f32_left_out=int((~keep32).sum()))
    del r_s32, r_f32
    errs32 = _step_err_list(steps32, fwd32, prompt - 1, keep32)
    err32, med32 = max(errs32), float(np.median(errs32))
    noise32, med_noise32, tol32 = None, None, F32_LOGIT_TOL
    if per_forward(cfg)["rwkv6_scan"]:
        plain = cfg.with_(attention_impl="xla_chunked")
        with plain_scans():
            ex = DecodeExecutor(plain, max_batch=serve_batch,
                                max_len=prompt + new, params=p32, device=dev,
                                cache_dtype=torch.float32, keep_logits=True)
            gen_p = np.stack(ex([{"prompt": q, "n_tokens": new}
                                 for q in prompts]))
            full_p = torch.from_numpy(np.concatenate([prompts, gen_p],
                                                     1)).to(dev)
            fwd_p, _ = transformer.model_apply(p32, plain,
                                               {"tokens": full_p})
        own = _step_err_list(ex.step_logits, fwd_p, prompt - 1)
        noise32, med_noise32 = max(own), float(np.median(own))
        tol32 = max(F32_LOGIT_TOL, NOISE_RATIO * noise32)
        del ex, fwd_p
    check(err32 <= tol32, f"serving f32: step logits differ from the "
          f"kernel-path forward's by {err32:.3e} of max|logit| (limit "
          f"{tol32:.3e}; the plain path's own: {noise32})")
    over32 = sum(e > F32_LOGIT_TOL for e in errs32)
    checked = tied = 0
    for t in range(new):
        want = fwd32[:, prompt - 1 + t]
        top2 = torch.topk(want, 2, dim=-1).values
        clear = ((top2[:, 0] - top2[:, 1])
                 > tol32 * float(want.abs().max()))
        if keep32 is not None:
            clear = clear & keep32[:, prompt - 1 + t]
        clear = clear.cpu().numpy()
        am = want.argmax(-1).cpu().numpy()
        bad = clear & (gen32[:, t] != am)
        check(not bad.any(), f"serving f32: step {t} greedy tokens "
              f"{gen32[bad, t]} are not the forward's argmax {am[bad]}")
        checked += int(clear.sum())
        tied += int((~clear).sum())
    del fwd32, steps32, p32, x32
    s.update({
        "serve_s": t_serve, "prefill_s": t_prefill,
        "decode_tokens_per_s": serve_batch * new / (t_serve - t_prefill),
        "prefill_tokens_per_s": serve_batch * prompt / t_prefill,
        "device_steps": n_steps, "step_drift": drift,
        "step_noise": step_noise, "fwd_noise": fwd_noise,
        "greedy_agree": agree, "step_err_f32": err32,
        "step_median_f32": med32, "step_over_f32": over32,
        "step_noise_f32": noise32, "step_noise_median_f32": med_noise32,
        "step_tol_f32": tol32,
        "greedy_checked": checked, "greedy_near_ties": tied})
    if keep:
        s["keep"] = (cfg, params)
    return s


# ---------------------------------------------------------------------------
# serve: the serving layer — PCScheduler over the sharded deadline PQ, the
# decode and structure executors, run_serving and its CLI
# ---------------------------------------------------------------------------
SERVE_SESSIONS = 8             # decode: 8 sessions x 4 requests (pc-async)
SERVE_PER_SESSION = 4
SERIAL_REQUESTS = 8            # serial decode takes ~1 s a request
PIPE_PER_SESSION = 2           # pipeline on / off: 8 sessions x 2, tier device
ORDER_REQUESTS = 64            # published behind a gated step
ORDER_ROUNDS_CAP = 4           # a pass chooses up to 4 x 8 = 32 requests
STRUCT_SESSIONS = 8            # pq structure serving: 8 sessions x 200
STRUCT_PER_SESSION = 200
CLI_FAULT_REQUESTS = 16        # --faults standard: 8 x 16, >= 4 passes
HEAP = ("heap_kmin", "heap_sift", "heap_insert")


class Recorder:
    """A step function that records each batch the executor applied, in
    order, with the answers it returned."""

    def __init__(self, ex):
        self.ex = ex
        self.batches = []

    def __call__(self, reqs):
        outs = self.ex(reqs)
        self.batches.append((list(reqs), outs))
        return outs


class FetchClock:
    """Times the blocking fetches (``batched_pq._host_fetch``) that the
    scheduler's ordering passes make — the deadline PQ's, not the
    executor's — by flagging the thread while it runs ``_order``."""

    def __init__(self, bpq, sch):
        self.bpq, self.sch = bpq, sch
        self.waits = []
        self.orders = []
        self._real_fetch = bpq._host_fetch
        self._tls = threading.local()

    def __enter__(self):
        tls, waits, real = self._tls, self.waits, self._real_fetch
        order, orders = self.sch._order, self.orders

        def fetch(tree):
            if not getattr(tls, "on", False):
                return real(tree)
            t0 = time.perf_counter()
            try:
                return real(tree)
            finally:
                waits.append(time.perf_counter() - t0)

        def timed_order(new):
            tls.on = True
            t0 = time.perf_counter()
            try:
                return order(new)
            finally:
                tls.on = False
                orders.append(time.perf_counter() - t0)

        self.bpq._host_fetch = fetch
        self.sch._order = timed_order
        return self

    def __exit__(self, *exc):
        self.bpq._host_fetch = self._real_fetch
        del self.sch._order

    def summary(self):
        w = self.waits
        return {"fetches": len(w),
                "fetch_ms_mean": 1e3 * float(np.mean(w)) if w else None,
                "fetch_ms_max": 1e3 * max(w) if w else None,
                "order_ms_mean": (1e3 * float(np.mean(self.orders))
                                  if self.orders else None)}


def _sessions(sch, tab, use_async):
    """``run_serving``'s client sessions: session s submits ``tab[s]``
    with deadlines s·per + j, all at once through ``submit_async`` (the
    pc-async client) or one at a time; returns the answers and seconds."""
    results, errors = {}, []

    def session(sid):
        try:
            per = len(tab[sid])
            reqs = [(tab[sid][j], float(sid * per + j)) for j in range(per)]
            if use_async:
                futs = [sch.submit_async(x, deadline=d) for x, d in reqs]
                results[sid] = [f.result(timeout=900) for f in futs]
            elif hasattr(sch, "submit_async"):
                results[sid] = [sch.submit_async(x, deadline=d).result(
                    timeout=900) for x, d in reqs]
            else:
                results[sid] = [sch.submit(x, deadline=d) for x, d in reqs]
        except BaseException as exc:       # re-raised on the main thread
            errors.append(exc)

    ts = [threading.Thread(target=session, args=(s,), daemon=True)
          for s in range(len(tab))]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "serve: session threads hung")
    if errors:
        raise errors[0]
    return [results[s] for s in range(len(tab))], seconds


def served_once(name, batches, tab, answers, max_batch):
    """Every request of ``tab`` reached the executor in exactly one batch
    of ≤ max_batch, and its client got that batch's answer."""
    by_id = {}
    for reqs, outs in batches:
        check(len(reqs) <= max_batch, f"{name}: a batch of {len(reqs)}")
        for r, o in zip(reqs, outs):
            check(id(r) not in by_id, f"{name}: a request served twice")
            by_id[id(r)] = o
    n = sum(len(row) for row in tab)
    check(len(by_id) == n, f"{name}: {len(by_id)} requests served of {n}")
    for row, got in zip(tab, answers):
        for r, g in zip(row, got):
            check(by_id[id(r)] is g, f"{name}: a client got another answer")


def _graph_replays(sch):
    """The scheduler's deadline PQ's graph replays (one a dispatch on the
    card, 0 on the CPU)."""
    pq = getattr(sch, "_pq", None)
    return None if pq is None else pq.graph_replays


def _launch_delta(counters, before):
    return {k: f.launches - before[k] for k, f in counters.items()}


def _snap(counters):
    return {k: f.launches for k, f in counters.items()}


def decode_serving(torch, dev, cfg, params, seed, counters, *, batch, prompt,
                   new):
    """Part a: ``PCScheduler(DecodeExecutor(...))`` under SERVE_SESSIONS
    pc-async sessions of SERVE_PER_SESSION requests, ``SerialScheduler``
    over the same executor on SERIAL_REQUESTS of them, every PC batch
    replayed through the executor (tokens bit-equal), and the pipeline on
    / off at tier device (PIPE_PER_SESSION requests a session) with the
    ordering passes' fetch waits."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.launch.serve import DecodeExecutor
    from repro_torch.serving import PCScheduler, SerialScheduler

    sessions, per = SERVE_SESSIONS, SERVE_PER_SESSION
    ex = DecodeExecutor(cfg, max_batch=batch, max_len=prompt + new + 1,
                        params=params, device=dev)
    rng = np.random.default_rng([seed, 18])
    prompts = rng.integers(2, cfg.vocab, (sessions * per, prompt),
                           dtype=np.int64).astype(np.int32)
    reqs = [{"prompt": p, "n_tokens": new} for p in prompts]
    ex(reqs[:1])                                # warm-up
    out = {}

    def run(name, sch_fn, tab, use_async):
        rec = Recorder(ex)
        steps0, before = ex.device_steps, _snap(counters)
        sch = sch_fn(rec)
        try:
            answers, secs = _sessions(sch, tab, use_async)
        finally:
            if isinstance(sch, PCScheduler):
                sch.close()
        served_once(name, rec.batches, tab, answers, batch)
        n = sum(len(row) for row in tab)
        s = {"requests": n, "seconds": secs, "req_per_s": n / secs,
             "tok_per_s": n * new / secs,
             "device_steps": ex.device_steps - steps0,
             "mean_batch": float(np.mean([len(b) for b, _ in rec.batches])),
             "calls": len(rec.batches),
             "heap_launches": {k: v for k, v in _launch_delta(
                 counters, before).items() if k in HEAP}}
        if isinstance(sch, PCScheduler):
            s.update(passes=sch.passes, eliminated=sch.eliminated,
                     pq_dispatches=sch.pq_dispatches,
                     pq_rounds=sch.pq_rounds,
                     graph_replays=_graph_replays(sch),
                     ordering_passes=sum(sch.tier_decisions.values()))
        return s, rec, answers

    tab = [reqs[s * per:(s + 1) * per] for s in range(sessions)]
    out["pc"], rec, answers = run(
        "serve pc", lambda st: PCScheduler(st, max_batch=batch, device=dev),
        tab, True)
    check(out["pc"]["mean_batch"] > 1, "serve pc: no batch held 2 requests")
    t0 = time.perf_counter()
    for b, (rs, outs) in enumerate(rec.batches):
        again = ex(rs)
        check(all(np.array_equal(a, o) for a, o in zip(again, outs)),
              f"serve pc: batch {b} replayed through the executor gives "
              "other tokens")
    out["replayed"] = len(rec.batches)
    out["replay_s"] = time.perf_counter() - t0

    stab = [[r] for r in reqs[:SERIAL_REQUESTS]]
    out["serial"], _, sanswers = run("serve serial", SerialScheduler, stab,
                                     False)
    pc_by_id = {id(r): o for row, got in zip(tab, answers)
                for r, o in zip(row, got)}
    out["serial_equal_pc"] = sum(
        np.array_equal(a[0], pc_by_id[id(row[0])])
        for row, a in zip(stab, sanswers))

    pipe = PIPE_PER_SESSION
    ptab = [reqs[s * pipe:(s + 1) * pipe] for s in range(sessions)]
    for pipeline in (True, False):
        clock = {}

        def make(st, pipeline=pipeline, clock=clock):
            sch = PCScheduler(st, max_batch=batch, tier="device",
                              pipeline=pipeline, device=dev)
            clock["c"] = FetchClock(bpq, sch).__enter__()
            return sch

        try:
            s, _, _ = run(f"serve pipeline={pipeline}", make, ptab, True)
        finally:
            if "c" in clock:
                clock["c"].__exit__()
        s.update(clock["c"].summary())
        out[f"pipeline_{'on' if pipeline else 'off'}"] = s
    return out


def order_check(torch, dev, seed, counters, *, batch,
                n_req=ORDER_REQUESTS, rounds_cap=ORDER_ROUNDS_CAP):
    """Part b: ``n_req`` requests with seeded deadlines published while
    the first (inline) step is gated, tier device: every ordering pass's
    chosen requests ascend by key, and one ordering pass (``_order``
    called while the combiner idles) makes exactly one blocking fetch."""
    from concurrent.futures import Future

    from repro_torch.core import batched_pq as bpq
    from repro_torch.serving import PCScheduler
    from repro_torch.serving.scheduler import BatchRequest, _Entry

    gate, started = threading.Event(), threading.Event()

    def step(rows):
        started.set()
        gate.wait(120)
        return rows

    before = _snap(counters)
    sch = PCScheduler(step, max_batch=batch, rounds_cap=rounds_cap,
                      tier="device", pipeline=False, supervise=False,
                      device=dev)
    real, passes = sch._order, []

    def recording(new):
        chosen = real(new)
        passes.append([e.key for b in chosen for e in b])
        return chosen

    sch._order = recording
    rng = np.random.default_rng([seed, 19])
    try:
        f0 = sch.submit_async(-1, deadline=-1.0)
        check(started.wait(120), "serve order: the first step never ran")
        deadlines = rng.uniform(0.0, 1000.0, n_req)
        futs = [sch.submit_async(i, deadline=float(d))
                for i, d in enumerate(deadlines)]
        gate.set()
        got = [f.result(timeout=300) for f in futs]
        check(got == list(range(n_req)) and f0.result(timeout=60) == -1,
              "serve order: a request got another answer")
        for p, keys in enumerate(passes):
            check(keys == sorted(keys), f"serve order: pass {p} chose "
                                        f"keys out of order {keys}")
        sizes = [len(k) for k in passes]
        check(sum(sizes) == n_req + 1 and max(sizes) <= rounds_cap * batch,
              f"serve order: passes chose {sizes}")
        check(sch.pq_dispatches > 0, "serve order: no deadline PQ dispatch")
        entries = [_Entry(BatchRequest(inputs=i, deadline=float(d)),
                          Future(), epoch=n_req + 1 + i)
                   for i, d in enumerate(rng.uniform(0.0, 1000.0, batch))]
        if dev.type == "cuda":
            chosen = one_fetch(torch, bpq, lambda: real(entries))
        else:
            chosen = real(entries)
        keys = [e.key for b in chosen for e in b]
        check(len(keys) == batch and keys == sorted(keys),
              "serve order: the one-fetch pass chose the wrong requests")
    finally:
        gate.set()
        sch.close()
    return {"passes": sizes, "pq_dispatches": sch.pq_dispatches,
            "pq_rounds": sch.pq_rounds, "graph_replays": _graph_replays(sch),
            "heap_launches": {k: v for k, v in _launch_delta(
                counters, before).items() if k in HEAP}}


def structure_serving(torch, dev, seed, counters, init, *, per, batch,
                      sessions=STRUCT_SESSIONS):
    """Part c: ``StructureExecutor(substrate.get("pq"))`` over K = 4 shards
    holding the pq phases' prefilled keys, driven through ``PCScheduler``
    (tier device, so each pass also runs the deadline PQ) by ``sessions``
    blocking sessions of ``per`` requests from ``_structure_requests`` at
    0 % reads: the PQ's only read, ``values``, dumps the whole heap.  Every
    applied batch is replayed in order through a ``SequentialBatchedPQ``
    built from the seeded ``init`` keys (the device's prefilled multiset
    must equal it first); every answer must satisfy ``spec.result_ok`` and
    the final multisets must be equal."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import substrate
    from repro_torch.core.sharded_pq import SequentialBatchedPQ
    from repro_torch.launch.serve import StructureExecutor, _structure_requests
    from repro_torch.serving import PCScheduler

    spec = substrate.get("pq")
    kw = dict(capacity=shard_capacity(len(init) + sessions * per, 4),
              c_max=C_MAX, n_shards=4)
    t0 = time.perf_counter()
    ex = StructureExecutor(spec, device=dev, values=init, **kw)
    oracle = SequentialBatchedPQ(init, c_max=C_MAX)
    check(np.array_equal(np.asarray(ex.ds.values(), np.float32),
                         np.asarray(oracle.values(), np.float32)),
          "serve pq: the prefilled multiset differs from the seeded keys")
    setup_s = time.perf_counter() - t0
    tab = _structure_requests(spec, np.random.default_rng([seed, 20]),
                              sessions, per, 0, kw)
    rec = Recorder(ex)
    before = _snap(counters)
    with PCScheduler(rec, max_batch=batch, tier="device", device=dev) as sch:
        with FetchClock(bpq, sch) as clock:
            answers, secs = _sessions(sch, tab, False)
    launches = _launch_delta(counters, before)
    served_once("serve pq", rec.batches, tab, answers, batch)
    t0 = time.perf_counter()
    for b, (rs, outs) in enumerate(rec.batches):
        ms = [r["method"] for r in rs]
        want = oracle.update_batch(ms, [r["input"] for r in rs])
        check(all(spec.result_ok(m, g, w)
                  for m, g, w in zip(ms, outs, want)),
              f"serve pq: batch {b} answers {outs} != the oracle's {want}")
    check(np.array_equal(np.asarray(ex.ds.values(), np.float32),
                         np.asarray(oracle.values(), np.float32)),
          "serve pq: final multiset differs from the oracle's")
    n = sessions * per
    ordering = sum(sch.tier_decisions.values())
    return {"requests": n, "seconds": secs, "ops_per_s": n / secs,
            "calls": len(rec.batches), "mean_batch": sch.mean_batch,
            "ordering_passes": ordering, "pq_dispatches": sch.pq_dispatches,
            "pq_rounds": sch.pq_rounds, "eliminated": sch.eliminated,
            "graph_replays": _graph_replays(sch),
            "capacity": kw["capacity"], "setup_s": setup_s,
            "replay_s": time.perf_counter() - t0,
            "heap_launches": {k: launches[k] for k in HEAP},
            "heap_per_pass": {k: launches[k] / max(ordering, 1)
                              for k in HEAP}, **clock.summary()}


def cli_serving(torch, dev, counters, runs=None):
    """Part d: ``serve.main`` once for each registered workload at the
    registry's ``serve_kw`` sizes (--scheduler pc-async), once on pq with
    --faults standard, and on pq with --megapass, plain and with --faults
    standard (or the ``(name, argv)`` pairs of ``runs``); each run must
    serve every request exactly once (the executor's batches counted by
    request identity), the faults runs must show a combiner takeover.
    The injected kill's traceback is counted (``threading.excepthook``),
    not printed."""
    import io

    from repro_torch.core import substrate
    from repro_torch.core.faults import InjectedCombinerKill
    from repro_torch.launch import serve

    if runs is None:
        runs = [(w, ["--workload", w, "--scheduler", "pc-async"])
                for w in substrate.names()]
        runs.append(("pq faults", ["--workload", "pq", "--scheduler",
                                   "pc-async", "--faults", "standard",
                                   "--requests", str(CLI_FAULT_REQUESTS)]))
        runs.append(("pq megapass", ["--workload", "pq", "--scheduler",
                                     "pc-async", "--megapass"]))
        runs.append(("pq megapass faults", [
            "--workload", "pq", "--scheduler", "pc-async", "--megapass",
            "--faults", "standard", "--requests", str(CLI_FAULT_REQUESTS)]))
    real_call = serve.StructureExecutor.__call__
    real_hook, kills = threading.excepthook, []

    def hook(args):
        if isinstance(args.exc_value, InjectedCombinerKill):
            kills.append(args.thread.name)
        else:
            real_hook(args)

    lines, before = [], _snap(counters)
    for name, argv in runs:
        seen = []

        def call(self, reqs, seen=seen):
            seen.extend(id(r) for r in reqs)
            return real_call(self, reqs)

        run_before, kills_before = _snap(counters), len(kills)
        serve.StructureExecutor.__call__ = call
        threading.excepthook = hook
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                stats = serve.main(argv + ["--device", dev.type])
        finally:
            serve.StructureExecutor.__call__ = real_call
            threading.excepthook = real_hook
        check(len(seen) == len(set(seen)) == stats["requests"],
              f"serve cli {name}: {len(seen)} requests applied "
              f"({len(set(seen))} distinct) of {stats['requests']}")
        if "faults" in name:
            check(stats["faults"]["scheduler_takeovers"] >= 1
                  and stats["faults"]["combiner_kills"]
                  == len(kills) - kills_before == 1,
                  f"serve cli: {len(kills)} combiner kills, "
                  f"{stats['faults']} under --faults standard")
        lines.append((name, stats, _nonzero(_launch_delta(counters,
                                                           run_before))))
    return lines, _launch_delta(counters, before)


def serve_phase(torch, dev, seed, counters, cfg, params, init, *,
                batch=SERVE_BATCH, prompt=SERVE_PROMPT, new=SERVE_NEW,
                struct_per=STRUCT_PER_SESSION, out=print):
    """Parts a-d (:func:`decode_serving`, :func:`order_check`,
    :func:`structure_serving`, :func:`cli_serving`) with every kernel's
    count set to 0 just before and read just after; the heap kernels,
    ``label_prop`` and ``sorted_merge`` must each have launched."""
    t_phase = time.perf_counter()
    s = {}

    def parts():
        t0 = time.perf_counter()
        s["decode"] = decode_serving(
            torch, dev, cfg, params, seed, counters, batch=batch,
            prompt=prompt, new=new)
        s["decode"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s["order"] = order_check(torch, dev, seed, counters, batch=batch)
        s["order"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s["structure"] = structure_serving(
            torch, dev, seed, counters, init, per=struct_per, batch=batch)
        s["structure"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s["cli"], s["cli_launches"] = cli_serving(torch, dev, counters)
        s["cli_s"] = time.perf_counter() - t0

    _, s["launches"] = counted(torch, dev, "serve", counters,
                               HEAP + ("label_prop", "sorted_merge"), parts)
    if dev.type == "cuda":
        for k in ("label_prop", "sorted_merge"):
            check(s["cli_launches"][k] > 0, f"serve cli: {k} never launched")
        for k in HEAP:
            check(s["order"]["heap_launches"][k] > 0
                  and s["structure"]["heap_launches"][k] > 0,
                  f"serve: {k} never launched by the deadline PQ")
    s["seconds"] = time.perf_counter() - t_phase
    for line in serve_lines(s, dev, batch, prompt, new):
        out(line)
    return s


def _ms(x):
    return "n/a" if x is None else f"{x:.3f}"


def serve_lines(s, dev, batch, prompt, new):
    d, o, st = s["decode"], s["order"], s["structure"]

    def rates(r):
        return (f"{r['req_per_s']:.3f} requests/s, {r['tok_per_s']:.1f} "
                f"generated tokens/s ({r['requests']} requests in "
                f"{r['seconds']:.3f} s), device_steps {r['device_steps']}, "
                f"{r['calls']} executor calls, mean batch "
                f"{r['mean_batch']:.3f}")

    def sched(r):
        return (f"passes {r['passes']} in {r['ordering_passes']} ordering "
                f"passes, eliminated {r['eliminated']}, pq_dispatches "
                f"{r['pq_dispatches']}, pq_rounds {r['pq_rounds']}, "
                f"deadline PQ graph replays {r['graph_replays']}, heap "
                f"launches {r['heap_launches']}")

    def pipe(r):
        return (f"{r['req_per_s']:.3f} requests/s, mean batch "
                f"{r['mean_batch']:.3f}, {r['fetches']} ordering fetches "
                f"waiting {_ms(r['fetch_ms_mean'])} ms on average (max "
                f"{_ms(r['fetch_ms_max'])}), ordering pass "
                f"{_ms(r['order_ms_mean'])} ms on average")

    yield (f"serve decode: {batch} slots x ({prompt} + {new}) tokens, "
           f"bf16 cache; pc-async: {rates(d['pc'])}, {sched(d['pc'])}; "
           f"serial: {rates(d['serial'])}, heap launches "
           f"{d['serial']['heap_launches']}; every request served once, "
           f"batches <= {batch}, {d['replayed']} PC batches replayed "
           f"through the executor with bit-equal tokens "
           f"({d['replay_s']:.1f} s); serial tokens equal to PC's for "
           f"{d['serial_equal_pc']}/{d['serial']['requests']} requests "
           f"(not held); tier device, pipeline on: "
           f"{pipe(d['pipeline_on'])}; pipeline off: "
           f"{pipe(d['pipeline_off'])} ({d['part_s']:.1f} s)")
    yield (f"serve order: {o['passes']} requests chosen by the ordering "
           f"passes, each ascending; pq_dispatches {o['pq_dispatches']}, "
           f"pq_rounds {o['pq_rounds']}, deadline PQ graph replays "
           f"{o['graph_replays']}, heap launches "
           f"{o['heap_launches']}; one ordering pass made one blocking "
           f"fetch" + ("" if dev.type == "cuda" else " (not checked here)")
           + f" ({o['part_s']:.1f} s)")
    yield (f"serve pq: {st['ops_per_s']:.1f} ops/s ({st['requests']} "
           f"requests in {st['seconds']:.3f} s, 8 sessions, 0% reads), "
           f"{st['calls']} executor calls, mean batch "
           f"{st['mean_batch']:.3f}, {st['ordering_passes']} ordering "
           f"passes, pq_dispatches {st['pq_dispatches']}, pq_rounds "
           f"{st['pq_rounds']}, deadline PQ graph replays "
           f"{st['graph_replays']}, heap launches {st['heap_launches']} "
           f"({', '.join(f'{k} {v:.2f}' for k, v in st['heap_per_pass'].items())}"
           f" an ordering pass, workload PQ included), ordering fetches "
           f"{st['fetches']} waiting {_ms(st['fetch_ms_mean'])} ms on "
           f"average (max {_ms(st['fetch_ms_max'])}), ordering pass "
           f"{_ms(st['order_ms_mean'])} ms; capacity {st['capacity']} a "
           f"shard, set-up {st['setup_s']:.1f} s; every request served "
           f"once, answers and final multiset equal to the oracle's "
           f"(replay {st['replay_s']:.1f} s; {st['part_s']:.1f} s)")
    for name, stats, launches in s["cli"]:
        yield f"serve cli {name}: {stats}; launches {launches}"
    yield (f"serve: kernel launches {_nonzero(s['launches'])}; "
           f"{s['seconds']:.1f} s")


def gemma2_phase(torch, dev, seed, counters, reduced=False, seq=GEMMA_SEQ):
    """Gemma2-2B at full width, ``GEMMA_LAYERS`` layers (one local with
    the 4,096 window, one full): the scoring forward (:func:`scoring`) on
    one sequence of ``seq`` tokens, past the window, so the window, the
    attention softcap, the sandwich norms, gelu-tanh and the scaled
    embedding go through the kernel path."""
    from repro_torch.models import transformer

    cfg = _model_cfg(GEMMA_ARCH, reduced, n_layers=GEMMA_LAYERS)
    rng = np.random.default_rng([seed, 15])
    params = transformer.model_init(seed, cfg, device=dev)
    s = scoring(torch, dev, "gemma2", cfg, params,
                model_inputs(torch, dev, cfg, rng, 1, seq), counters)
    check(s["max_logit"] <= cfg.logit_softcap + 1e-3,
          "gemma2: logits past the final softcap")
    s["params"] = transformer.count_params(params)
    return s


# ---------------------------------------------------------------------------
# the recurrent families: rwkv6_scan, rglru_scan and their models
# ---------------------------------------------------------------------------
# (B, S, H, hd, chunk): the CPU tests' RWKV_CASES
# (tests/test_torch_linear_scan.py: test_kernels.py:78-79, S = 1, a chunk
# past the sequence)
RWKV_CASES = [(2, 128, 2, 16, 32), (1, 100, 3, 32, 64), (2, 64, 1, 8, 64),
              (1, 256, 2, 16, 16), (3, 1, 2, 16, 64), (2, 40, 2, 64, 64)]
# (B, S, R): the CPU tests' RGLRU_CASES (test_kernels.py:113-114, S = 1)
RGLRU_CASES = [(2, 128, 64), (1, 100, 48), (3, 64, 16), (4, 1, 32)]
SCAN_Y_TOL = 1e-4              # of max|y|: tests/test_kernels.py:94-95
SCAN_S_ATOL, SCAN_S_RTOL = 1e-3, 1e-4   # S_T: tests/test_kernels.py:96
RWKV_ARCH = "rwkv6_3b"         # full width and depth
RWKV_BATCH = 4                 # scoring: 4 x 4,096 tokens
RWKV_SEQ = 4096
RG_ARCH = "recurrentgemma_2b"  # full width, one (rglru, rglru, local) period
RG_LAYERS = 3
RG_SEQ = 8192                  # scoring: 1 x 8,192 tokens, past the window
RG_D_RNN = 2560
# the phases' scan shapes: RWKV-6 3B's 40 heads of 64 at scoring and at
# serving's prefill; RecurrentGemma's d_rnn at scoring and serving
RWKV_SHAPES = ((RWKV_BATCH, RWKV_SEQ, 40, 64),
               (SERVE_BATCH, SERVE_PROMPT, 40, 64))
RGLRU_SHAPES = ((1, RG_SEQ, RG_D_RNN), (SERVE_BATCH, SERVE_PROMPT, RG_D_RNN))
# rwkv6_scan's serving launches, timed beside the scoring shape: the
# prefill of 8 x 512-token prompts and one decode step of 8 requests
RWKV_SERVE_SHAPES = (("prefill", (SERVE_BATCH, SERVE_PROMPT, 40, 64)),
                     ("decode", (SERVE_BATCH, 1, 40, 64)))
# decays past the reference's chunked domain (sum |log w| < ~80 over a
# 64-token chunk), held against the exact scan only: |log w| = 4 a token
# (256 a chunk); RWKV-6's w = exp(-exp(w0)) with w0 over [-6, 1.5]; the
# reference test's draw with 5 % of the decays exactly 0
PAST_DOMAIN = ("|log w| = 4", "w0 in [-6, 1.5]", "5% w = 0")
RWKV_PAST_SHAPES = ((2, 256, 4, 64), (1, 1024, 8, 64))
# sequence lengths around the per-token body's limit (16) and the chunked
# body's chunk (64)
RWKV_TAILS = (15, 17, 63, 65, 127)
# inputs whose rows the chunked body cannot stage by 16-byte copies (plain
# loads instead): hd 12 (24-byte bf16 rows) and views one element into
# their storage (every row misaligned)
RWKV_UNALIGNED = (((2, 100, 3, 12), "rows"), ((2, 100, 3, 64), "offset"))
RWKV_FILL = (3, 6)             # batches timed beside the scoring shape's
# rglru_scan's ragged layouts (csrc/rglru_scan.cu: element copies, the last
# channel tile and the last stage): R not a multiple of 4 (4-byte copies
# and stores), views one element into their storage (every row
# misaligned), S = 1, S not a multiple of a stage's steps, B x R below one
# CTA's channels, and a last channel tile cut short on 16-byte copies
RGLRU_RAGGED = (((1, 100, 50), None), ((2, 77, RG_D_RNN), "offset"),
                ((2, 1, RG_D_RNN), None), ((1, 200, RG_D_RNN), None),
                ((1, 50, 12), None), ((2, 100, 40), None))


def _offset_view(torch, x):
    """A copy of ``x`` as a view one element into its storage (so no row
    starts on 16 bytes)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def _rwkv_inputs(torch, gen, dev, B, S, H, hd, dtype, decay=None):
    """r, k, v standard normal in ``dtype``; log w = -exp(U(-3, 0.5)) as
    the reference's test draws it, or a fixed ``decay`` with zero u and
    state0 (the strong-decay case), or one of ``PAST_DOMAIN``'s draws;
    u and state0 normal; w, u, state0 f32.  ``decay`` "offset" gives the
    reference draw as views one element into their storage, "rows" the
    reference draw itself (named apart for the case list)."""
    shape = (B, S, H, hd)
    if decay == "offset":        # views one element into their storage
        r, k, v, w, u, s0 = _rwkv_inputs(torch, gen, dev, B, S, H, hd, dtype)
        return (*(_offset_view(torch, x) for x in (r, k, v, w)), u, s0)
    r, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    if decay is None or decay in PAST_DOMAIN or decay == "rows":
        if decay == PAST_DOMAIN[0]:
            w = torch.full(shape, math.exp(-4.0), device=dev)
        elif decay == PAST_DOMAIN[1]:
            w = torch.exp(-torch.exp(torch.rand(
                shape, generator=gen, device=dev) * 7.5 - 6.0))
        else:
            w = torch.exp(-torch.exp(torch.rand(
                shape, generator=gen, device=dev) * 3.5 - 3.0))
        if decay == PAST_DOMAIN[2]:
            w = torch.where(torch.rand(shape, generator=gen, device=dev)
                            < 0.05, 0.0, w)
        u = torch.randn((H, hd), generator=gen, device=dev)
        s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev)
    else:
        w = torch.full(shape, decay, device=dev)
        u = torch.zeros((H, hd), device=dev)
        s0 = torch.zeros((B, H, hd, hd), device=dev)
    return r, k, v, w, u, s0


def _rwkv_err(torch, got, want, what):
    """Raise unless y is within SCAN_Y_TOL of max|y| and S_T within atol
    SCAN_S_ATOL / rtol SCAN_S_RTOL of ``want``'s; returns max|Δy|."""
    (y, sT), (yr, sr) = got, want
    check(bool(torch.isfinite(y).all() and torch.isfinite(sT).all()),
          f"rwkv6_scan {what}: non-finite output")
    e = float((y - yr).abs().max()) if y.numel() else 0.0
    scale = float(yr.abs().max()) + 1e-9 if y.numel() else 1.0
    check(e / scale < SCAN_Y_TOL, f"rwkv6_scan {what}: y off by "
          f"{e / scale:.3e} of max|y| (limit {SCAN_Y_TOL})")
    bad = int(((sT - sr).abs() > SCAN_S_ATOL + SCAN_S_RTOL * sr.abs()).sum())
    check(bad == 0, f"rwkv6_scan {what}: {bad} S_T elements outside atol "
                    f"{SCAN_S_ATOL} / rtol {SCAN_S_RTOL}")
    return e


def scan_bounds(kind, shape, itemsize):
    """The least time of one call: the bytes the function must move (each
    input read once, each output written once) over 3.35 TB/s against its
    f32 FLOP at the rate of the units that can do them.  RWKV-6: r, k, v
    in ``itemsize`` bytes, w, y in f32, state0 and S_T (hd x hd) in f32;
    5 FLOP a state element a step (the decay multiply-add w∘S + k⊗v, and
    r·S), which the chunked form does as matrix products at f32 accuracy
    on the tensor cores (3xTF32: three TF32 products an f32 one, 495 / 3
    TFLOP/s); the f32 CUDA-core time (67 TFLOP/s) is returned beside it.
    RG-LRU: a, b, h in f32 and h0, h_T; 2 FLOP an element on the CUDA
    cores.  Returns (ms, by, FLOP, bytes, CUDA-core ms)."""
    if kind == "rwkv6_scan":
        B, S, H, hd = shape
        n = B * S * H * hd
        nbytes = 3 * itemsize * n + 8 * n + 8 * B * H * hd * hd + 4 * H * hd
        flop = 5 * B * S * H * hd * hd
        rate = TF32_OPS_PER_S / 3
    else:
        B, S, R = shape
        nbytes = 12 * B * S * R + 8 * B * R
        flop = 2 * B * S * R
        rate = F32_OPS_PER_S
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flop / rate * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms
            else "operations", flop, nbytes, flop / F32_OPS_PER_S * 1e3)


def linear_scan_phase(torch, dev, seed, rwkv_shapes, rglru_shapes, timing):
    """``rwkv6_scan`` and ``rglru_scan`` (the kernels on CUDA tensors)
    against their plain versions and the exact scans of ``ref.py``:

    - ``rwkv6_scan`` on every CPU case (``RWKV_CASES``), the strong-decay
      case (|log w| = 1, chunk 32, as ``test_rwkv6_strong_decay_domain``),
      the tail lengths ``RWKV_TAILS`` (the per-token body below 16 tokens,
      the chunked body's partial chunks) and ``rwkv_shapes`` (the phases'
      scoring and serving-prefill shapes, chunk 64; nonzero ``state0``
      everywhere but the strong-decay case), each with f32 and with bf16
      r, k, v: y within SCAN_Y_TOL of max|y| and S_T within atol
      SCAN_S_ATOL / rtol SCAN_S_RTOL of both; then the decays past the
      plain version's domain (``PAST_DOMAIN`` at ``RWKV_PAST_SHAPES``,
      exact zeros among them), where the chunked plain form overflows,
      held to the exact scan alone at the same tolerances;
    - ``rglru_scan`` on every CPU case (``RGLRU_CASES``, nonzero h0),
      ``rglru_shapes`` and the ragged layouts ``RGLRU_RAGGED``: h and
      h_T bit-equal to both (the same two roundings, no FMA).

    Then at the first shape of each (the model's dtypes: bf16 r, k, v and
    f32 w; f32 a, b) the kernel's ms, the plain version's and the bound
    (:func:`scan_bounds`), ``rglru_scan``'s ms and bound at the last of
    ``rglru_shapes`` (the serving prefill), and for ``rwkv6_scan`` the
    serving launches' shapes (``RWKV_SERVE_SHAPES``) and, at the scoring
    and prefill shapes,
    the per-token body alone (``rwkv6_scan_body("step", ...)``, the
    exact recurrence the chunked body replaced there) beside the chunked
    one.  No single PyTorch call
    computes either recurrence, so there is no library yardstick."""
    from repro_torch.kernels.linear_scan import (rglru_scan, rglru_scan_plain,
                                                 rwkv6_scan, rwkv6_scan_plain)
    from repro_torch.kernels.linear_scan.ops import rwkv6_scan_body
    from repro_torch.kernels.linear_scan.ref import (rglru_reference,
                                                     rwkv6_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rec = {"rwkv6_scan": {"checked": 0, "max_abs_err": 0.0,
                          "max_abs_err_ref": 0.0, "past_domain_err": 0.0},
           "rglru_scan": {"checked": 0, "max_abs_err": 0.0}}
    cases = [(c[:4], c[4], None) for c in RWKV_CASES]
    cases += [((1, 64, 2, 16), 32, math.exp(-1.0))]
    cases += [((2, S, 4, 64), 64, None) for S in RWKV_TAILS]
    cases += [(shape, 64, kind) for shape, kind in RWKV_UNALIGNED]
    cases += [(shape, 64, None) for shape in rwkv_shapes]
    if dev.type == "cuda":     # on the host the wrapper is the plain form
        cases += [(shape, 64, kind) for kind in PAST_DOMAIN
                  for shape in RWKV_PAST_SHAPES]
    r6 = rec["rwkv6_scan"]
    r6["cases"] = len(cases)
    kept = {}
    for shape, chunk, decay in cases:
        past = decay in PAST_DOMAIN
        for dt in (torch.float32, torch.bfloat16):
            args = _rwkv_inputs(torch, gen, dev, *shape, dt, decay)
            what = f"{shape} {decay or ''} chunk {chunk} {str(dt)[6:]}"
            got = rwkv6_scan(*args, chunk=chunk)
            if not past:
                e = _rwkv_err(torch, got, rwkv6_scan_plain(
                    *args, chunk=chunk), what + " vs plain")
                r6["max_abs_err"] = max(r6["max_abs_err"], e)
            e_ref = _rwkv_err(torch, got, rwkv6_reference(*args),
                              what + " vs the exact scan")
            r6["max_abs_err_ref"] = max(r6["max_abs_err_ref"], e_ref)
            if past:
                r6["past_domain_err"] = max(r6["past_domain_err"], e_ref)
            r6["checked"] += 1
            if shape == rwkv_shapes[0] and dt == torch.bfloat16 and not past:
                kept["rwkv6_scan"] = args
            del args, got
    rg = rec["rglru_scan"]
    for shape, kind in ([(s, None) for s in RGLRU_CASES + list(rglru_shapes)]
                        + list(RGLRU_RAGGED)):
        B, S, R = shape
        a = torch.rand((B, S, R), generator=gen, device=dev) * 0.8 + 0.2
        b = torch.randn((B, S, R), generator=gen, device=dev)
        h0 = torch.randn((B, R), generator=gen, device=dev)
        if kind == "offset":
            a, b = _offset_view(torch, a), _offset_view(torch, b)
        hs, hT = rglru_scan(a, b, h0)
        for name, (ws, wT) in (("plain", rglru_scan_plain(a, b, h0)),
                               ("exact scan", rglru_reference(a, b, h0))):
            e = max(float((hs - ws).abs().max()) if hs.numel() else 0.0,
                    float((hT - wT).abs().max()))
            check(torch.equal(hs, ws) and torch.equal(hT, wT),
                  f"rglru_scan {shape} {kind or ''}: not bit-equal to the "
                  f"{name} (max_abs_err {e})")
            rg["max_abs_err"] = max(rg["max_abs_err"], e)
        rg["checked"] += 1
        if kind is None and shape == tuple(rglru_shapes[0]):
            kept["rglru_scan"] = (a, b, torch.zeros_like(h0))
        if kind is None and shape == tuple(rglru_shapes[-1]):
            kept["rglru_prefill"] = (a, b, torch.zeros_like(h0))
        del a, b, h0, hs, hT
    rg["cases"] = len(RGLRU_CASES) + len(rglru_shapes) + len(RGLRU_RAGGED)
    if not timing:
        return rec
    for name, fn, plain in (("rwkv6_scan", rwkv6_scan, rwkv6_scan_plain),
                            ("rglru_scan", rglru_scan, rglru_scan_plain)):
        args = kept[name]
        r = rec[name]
        r["ms"] = _per_call_ms(torch, lambda: fn(*args), 10, 5, hold=True)
        r["plain_ms"] = _per_call_ms(torch, lambda: plain(*args), 1, 2,
                                     hold=False)
        r["shape"] = list(args[0].shape)
        (r["bound_ms"], r["bound_by"], r["flop"], r["bytes"],
         r["cuda_core_ms"]) = scan_bounds(name, args[0].shape,
                                          args[0].element_size())
        r["library_ms"] = None
    # RecurrentGemma's serving prefill: 8x the CTAs, a chain of 512 steps
    args = kept["rglru_prefill"]
    rg["prefill_shape"] = list(args[0].shape)
    rg["prefill_ms"] = _per_call_ms(torch, lambda: rglru_scan(*args), 10, 5,
                                    hold=True)
    rg["prefill_bound_ms"] = scan_bounds("rglru_scan", args[0].shape, 4)[0]
    args = kept["rwkv6_scan"]
    r6["step_ms"] = _per_call_ms(
        torch, lambda: rwkv6_scan_body("step", *args), 10, 5, hold=True)
    # the grid's fill: one CTA a (b, h) on 132 SMs, at B = 3 (120 CTAs,
    # one an SM) and B = 6 (240, two on most SMs) beside the scoring B
    r6["by_batch"] = {}
    for B in RWKV_FILL:
        shape = (B,) + tuple(args[0].shape[1:])
        fill = _rwkv_inputs(torch, gen, dev, *shape, torch.bfloat16)
        r6["by_batch"][B] = _per_call_ms(torch, lambda: rwkv6_scan(*fill),
                                         10, 5, hold=True)
        del fill
    for label, shape in RWKV_SERVE_SHAPES:
        args = _rwkv_inputs(torch, gen, dev, *shape, torch.bfloat16)
        r6[label + "_shape"] = list(shape)
        r6[label + "_ms"] = _per_call_ms(torch, lambda: rwkv6_scan(*args),
                                         10 if shape[1] > 1 else 30, 5,
                                         hold=True)
        if shape[1] >= 16:
            r6[label + "_step_ms"] = _per_call_ms(
                torch, lambda: rwkv6_scan_body("step", *args), 10, 5,
                hold=True)
        r6[label + "_bound_ms"] = scan_bounds("rwkv6_scan", shape, 2)[0]
        del args
    return rec


def scan_line(ls, seconds, timing):
    """The ``kernels:`` line of :func:`linear_scan_phase`'s records."""
    r6, rg = ls["rwkv6_scan"], ls["rglru_scan"]
    line = (f"kernels: rwkv6_scan vs plain and the exact scan on "
            f"{r6['checked']} launches ({r6['cases']} cases x f32, bf16 "
            f"r/k/v; max_abs_err {r6['max_abs_err']} vs plain, "
            f"{r6['max_abs_err_ref']} vs exact, {r6['past_domain_err']} "
            f"past the plain version's domain (vs exact only); y within "
            f"{SCAN_Y_TOL} of max|y|, S_T atol {SCAN_S_ATOL} / rtol "
            f"{SCAN_S_RTOL}); rglru_scan == plain == exact scan bit for bit "
            f"on {rg['checked']} launches ({rg['cases']} cases, the ragged "
            f"and offset ones among them) ({seconds:.1f} s); ")
    if not timing:
        return line + "timing not measured"
    line += " ".join(
        f"{k}: ms {r['ms']:.6f} at {r['shape']} plain_ms "
        f"{r['plain_ms']:.6f} bound_ms {r['bound_ms']:.6f} "
        f"({r['bound_by']}: {r['bytes']} bytes / 3.35 TB/s; {r['flop']:.4e} "
        f"FLOP: {r['cuda_core_ms']:.6f} ms at 67 TFLOP/s f32 on the CUDA "
        f"cores" + (f", {r['flop'] / TF32_OPS_PER_S * 3e3:.6f} ms as 3xTF32 "
                    f"at 495 / 3 TFLOP/s" if k == "rwkv6_scan" else "")
        + ") library_ms None;" for k, r in ls.items())
    line += (f" rglru_scan serving prefill {rg['prefill_shape']} ms "
             f"{rg['prefill_ms']:.6f} bound_ms {rg['prefill_bound_ms']:.6f};")
    return line + (f" rwkv6_scan per-token body alone {r6['step_ms']:.6f} "
                   f"ms at {r6['shape']}; by batch (CTAs = 40 B on 132 SMs): "
                   + ", ".join(f"B {B} {ms:.6f} ms"
                               for B, ms in r6["by_batch"].items())
                   + "; serving: ") + "; ".join(
        f"{label} {r6[label + '_shape']} ms {r6[label + '_ms']:.6f}"
        + (f" (per-token body {r6[label + '_step_ms']:.6f})"
           if label + "_step_ms" in r6 else "")
        + f" bound_ms {r6[label + '_bound_ms']:.6f}"
        for label, _ in RWKV_SERVE_SHAPES)


def slow_decay(torch, params, seed):
    """Redraw every RG-LRU ``lam`` from U(-8, -4), from ``seed`` on its
    device.  ``model_init`` draws it from U(2.2, 7.0) as the reference
    does, which makes a = exp(-8·r·softplus(lam)) ≈ 1e-8: the recurrence
    would carry almost nothing from one token to the next, and neither
    the scan's state nor the prefill-to-decode hand-off of ``h`` would
    show in the checks.  U(-8, -4) gives a in ~(0.9, 0.999), the range
    the reference's init comment names."""
    gen = None
    for blk in tuple(params["stack"]) + tuple(params["rem"]):
        lam = blk["mixer"].get("lam")
        if lam is not None:
            if gen is None:
                gen = torch.Generator(device=lam.device)
                gen.manual_seed(seed)
            lam.copy_(torch.rand(lam.shape, generator=gen,
                                 device=lam.device) * 4.0 - 8.0)


def _nonzero(counts):
    """The nonzero entries of a {kernel: count} dict, for the phase lines."""
    return {k: n for k, n in counts.items() if n}


def _profile(torch, name, one, n_passes, what, out):
    """Host time per call of ``one()`` over ``n_passes`` (after 20
    warm-up calls), then 100 calls under torch.profiler: device time and
    busy share, kernel launches and memcpy calls per call, the
    hand-written kernels' device time per launch, the busiest ops."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):                       # warm-up
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_passes):
        one()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n_passes * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(100):
            one()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    ka = prof.key_averages()
    rows = device_rows(ka)
    dev_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in ka if e.key in LAUNCH_CALLS)
    memcpy = sum(e.count for e in ka if e.key.startswith("cudaMemcpy"))
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    ours_rx = r"\b(%s)(_\w+)?_kernel(<[^>]*>)?\(" % "|".join(REPLACES)
    ours = [f"{m.group(0)[:-1]} {e.self_device_time_total / e.count:.3f} "
            f"us/launch x {e.count}" for e in rows if e.count
            for m in [re.search(ours_rx, e.key)] if m]
    out(f"profile {name}: single-thread pass {host_ms:.3f} ms (host "
        f"clock, {n_passes} passes of {what}); under the profiler "
        f"{prof_wall * 10:.3f} ms/pass wall, device "
        f"{dev_us / 100 / 1e3:.4f} ms/pass (busy share "
        f"{dev_us / 1e6 / prof_wall:.4f}), {launches / 100:.1f} kernel "
        f"launches and {memcpy / 100:.1f} memcpy calls per pass; "
        f"hand-written kernels on the device: " + "; ".join(ours)
        + "; top device ops: " + "; ".join(
            f"{e.key} {e.self_device_time_total / 100:.2f} us/pass"
            for e in top))


def profile_passes(seed=0, n_keys=N_KEYS, n_passes=300, width=4,
                   threads=THREADS, ops=300, n=GRAPH_VERTICES,
                   map_keys=MAP_KEYS, out=print):
    """``--profile``: where a pass's time goes, at the main paths' sizes.
    For both queues: (1) ``n_passes`` single-thread ``apply`` calls of up
    to ``width`` extracts + inserts each (the threaded runs' mean batch
    is about 4), host clock, then 100 under torch.profiler
    (:func:`_profile`); (2) the same queue under ``threads`` clients, host
    time per combining pass.  For the graph (half a random tree of n
    vertices live, loaded straight into the edge buffer) and the
    union-find (n vertices), the map and the sketch (``map_keys`` keys):
    single-thread combining passes of one update and three reads (about
    the threaded runs' mean batch), as the combiner runs them, through
    :func:`_profile`."""
    import torch

    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
    from repro_torch.core.batched_map import ShardedMap
    from repro_torch.core.batched_sketch import ShardedSketch
    from repro_torch.core.batched_union_find import BatchedUnionFind
    from repro_torch.core.device_graph import DeviceGraph
    from repro_torch.core.pc_pq import pc_priority_queue

    dev = torch.device("cuda")
    rng = np.random.default_rng([seed, 0])
    init = rng.uniform(0, KEY_RANGE, n_keys).astype(np.float32)
    total = n_keys + 2 * n_passes * width + threads * ops + 2
    for name, pq in (
            ("pq-single", bpq.BatchedPriorityQueue(
                shard_capacity(total, 1), C_MAX, values=init, device=dev)),
            ("pq-sharded", spq.ShardedBatchedPQ(
                shard_capacity(total, 4), C_MAX, n_shards=4, values=init,
                device=dev))):
        r = np.random.default_rng([seed, 4])

        def one():
            ins = r.uniform(0, KEY_RANGE, int(r.integers(0, width + 1)))
            pq.apply(int(r.integers(0, width + 1)), ins.astype(np.float32))

        _profile(torch, name, one, n_passes,
                 f"<= {width}+{width} ops", out)
        engine = pc_priority_queue(pq)
        _, _, seconds = drive(engine, threads, ops, seed)
        torch.cuda.synchronize()
        out(f"profile {name}: {threads} threads x {ops} ops: "
            f"{seconds / engine.passes * 1e3:.3f} ms per combining pass, "
            f"mean batch {float(np.mean(engine.combined_sizes)):.3f}, "
            f"{threads * ops / seconds:.1f} ops/s")
        del pq, engine

    r = np.random.default_rng([seed, 12])
    tu, tv = random_tree(r, n)
    tree = list(zip(tu.tolist(), tv.tolist()))
    g = DeviceGraph(n, edge_capacity=(n - 1) + 2 * C_MAX, c_max=C_MAX,
                    n_shards=4, device=dev)
    half = r.random(n - 1) < 0.5
    m = int(half.sum())
    g.state.eu[:m] = torch.from_numpy(np.minimum(tu, tv)[half]).to(dev)
    g.state.ev[:m] = torch.from_numpy(np.maximum(tu, tv)[half]).to(dev)
    g.state.valid[:m] = True
    g.state.dirty_full.fill_(True)
    g._n_edges, g._maybe_stale = m, True
    for name, ds, update in (
            ("graph", g, lambda: (
                "insert" if r.random() < 0.5 else "delete",
                tree[int(r.integers(len(tree)))])),
            ("unionfind", BatchedUnionFind(n, c_max=C_MAX, device=dev),
             lambda: ("union", (int(r.integers(n)), int(r.integers(n)))))):
        def one():
            # one combining pass as batched_read_optimized runs it: the
            # update dispatched, the reads answered by one read pass
            # whose fetch also resolves the update's result
            m, e = update()
            h = ds.update_batch_async([m], [e])
            ds.read_batch(["connected"] * 3,
                          [(int(r.integers(n)), int(r.integers(n)))
                           for _ in range(3)])
            h.result()

        _profile(torch, name, one, n_passes,
                 "one update + three connected", out)

    r = np.random.default_rng([seed, 20])
    keys = grid_keys(r, map_keys)
    vals = r.uniform(0, 10, map_keys).astype(np.float32)
    cap = shard_capacity(map_keys + 2 * n_passes + 400, 4)
    m = ShardedMap(cap, C_MAX, n_shards=4, key_range=MAP_KEY_RANGE,
                   items=list(zip(keys.tolist(), vals.tolist())),
                   device=dev)
    sk = ShardedSketch(cap, C_MAX, n_shards=4, topk_max=TOPK_MAX,
                       items=[(k, 5.0) for k in keys.tolist()], device=dev)
    for name, ds, op in (("map", m, lambda: map_op(r, keys, map_keys)),
                         ("sketch", sk, lambda: sketch_op(r, keys))):
        def draw(update):
            while True:
                mt, i = op()
                if (mt in ds.read_only) != update:
                    return mt, i

        def one():
            # one combining pass of the threaded phases' mean batch: an
            # update and three reads of the bench mix, as
            # batched_read_optimized runs them
            mt, i = draw(True)
            h = ds.update_batch_async([mt], [i])
            reads = [draw(False) for _ in range(3)]
            ds.read_batch([q for q, _ in reads], [x for _, x in reads])
            h.result()

        _profile(torch, name, one, n_passes,
                 "one update + three reads of the bench mix", out)


def model_runner(torch, dev, seed, counters, results, *, reduced,
                 serve_batch, serve_prompt, serve_new, out=print):
    """``lm(key, phase, **kw)``: run one model phase with a fresh peak
    memory count, keep its stats in ``results[key]`` and print its lines
    (scoring, serving, routing, the profiled forward)."""

    def lm(key, phase, **kw):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = phase(torch, dev, seed, counters, reduced=reduced, **kw)
        if dev.type == "cuda":
            s["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        s["seconds"] = time.perf_counter() - t0
        results[key] = s
        extra = "" if "serve_s" not in s else (
            f"; serving: {serve_batch} requests x {serve_prompt}-token "
            f"prompts + {serve_new} new tokens in {s['serve_s']:.3f} s "
            f"(prefill alone {s['prefill_s']:.3f} s, "
            f"{s['prefill_tokens_per_s']:.1f} prompt tokens/s; decode "
            f"{s['decode_tokens_per_s']:.1f} tokens/s), "
            f"kernel launches in the counted call of "
            f"{s['device_steps']} device steps "
            f"{_nonzero(s['serve_launches'])}; bf16 step "
            f"logits {s['step_drift']:.3e} of max|logit| off the bf16 "
            f"kernel-path forward ({s['greedy_agree']}/"
            f"{serve_batch * serve_new} greedy tokens its argmax), "
            f"{s['step_noise']:.3e} off the f32 forward (the bf16 forward: "
            f"{s['fwd_noise']:.3e}); f32 step logits within "
            f"{s['step_err_f32']:.3e} of the f32 kernel-path forward "
            f"(median {s['step_median_f32']:.3e}, {s['step_over_f32']}/"
            f"{serve_new + 1} steps over {F32_LOGIT_TOL:.0e}; limit "
            f"{s['step_tol_f32']:.3e}; the plain path's own "
            f"{s['step_noise_f32']}, median "
            f"{s['step_noise_median_f32']}), "
            f"{s['greedy_checked']} greedy tokens its argmax "
            f"({s['greedy_near_ties']} near-ties not held)")
        per_fwd = (_nonzero(s["per_forward"]) or "none: no hand-written "
                   "kernel launched, checked")
        out(f"{key}: {s['params']} params; scoring {s['tokens_per_s']:.1f} "
            f"tokens/s (loss_fn {s['loss_s']:.3f} s, model_apply "
            f"{s['forward_s']:.3f} s), kernel launches "
            f"{_nonzero(s['launches'])} (per forward {per_fwd}), loss "
            f"{s['loss']:.6f} vs plain "
            f"path {s['plain_loss']:.6f}; layer mixer outputs within "
            f"{s['layer_err']:.3e} of the plain path's; f32 logits within "
            f"{s['f32_err']:.3e} of max|logit| at positions {s['head']}.. "
            f"(limit {F32_LOGIT_TOL:.0e}; the two plain f32 paths "
            f"{s['f32_noise']})" + ("" if not s["head"] else
            f", {s['head_err']:.3e} at positions 0-{s['head'] - 1} (limit "
            f"{s['head_tol']:.3e}; the two plain f32 paths "
            f"{s['head_noise']:.3e})") + f"; bf16 logits "
            f"{s['bf16_vs_plain']:.3e} of max|logit| {s['max_logit']:.3f} "
            f"off the plain path's, {s['kernel_noise']:.3e} off the f32 "
            f"forward at positions {s['head']}.. (plain path "
            f"{s['plain_noise']:.3e}, limit {NOISE_RATIO}x)" + (
                "" if not s["head"] else
                f", at positions 0-{s['head'] - 1} {s['head_bf16'][0]:.3e} "
                f"(plain path {s['head_bf16'][1]:.3e}; not held)")
            + ("" if s["decay_chunk_max"] is None else
               f"; the layers' scans saw sum |log w| up to "
               f"{s['decay_chunk_max']:.3f} over a 64-token chunk (the "
               f"reference's chunked form holds below ~80)")
            + f"{extra}{routing_line(s['routing'])}; "
            f"max_memory_allocated {s.get('max_memory_allocated', 'n/a')} "
            f"({s['seconds']:.1f} s)")
        pr = s["profile"]
        if pr:
            out(f"{key}: one bf16 model_apply under the profiler: "
                f"{pr['wall_ms']:.3f} ms wall, {pr['device_ms']:.3f} ms of "
                f"device time (busy share {pr['busy_share']:.4f}), "
                f"{pr['launches']} kernel launches; busiest: " + "; ".join(
                    f"{k} {ms:.3f} ms x {n}" for k, ms, n in pr["top"])
                + "; hand-written: " + ("; ".join(
                    f"{k} {ms:.3f} ms x {n} ({ms / n:.4f} a launch)"
                    for k, (ms, n) in pr["ours"].items()) or "none"))

    return lm


def routing_line(r):
    """The MoE phases' routing numbers (:func:`scoring`, :func:`model_phase`)
    for the phase line; empty without MoE layers."""
    if not r:
        return ""
    line = (f"; routing: scoring forward dropped {r['drop']:.4f} of its "
            f"assignments at the config's capacity factor; f32 kernel path "
            f"vs plain path: {r['f32_flipped']} of {r['tokens']} tokens "
            f"routed or kept differently, {r['f32_near']} under the "
            f"{ROUTE_MARGIN} margin (every flip is under it), "
            f"{r['f32_left_out']} positions from a flip on left out of the "
            f"f32 check; bf16 kernel path vs the f32 forward: "
            f"{r['bf16_flipped']} tokens routed or kept differently, "
            f"{r['bf16_excluded']:.4f} of the positions (either bf16 path) "
            f"left out of the bf16 check")
    if "decode_drop" in r:
        line += (f"; one decode step ({r['decode_tokens']} tokens) dropped "
                 f"{r['decode_drop']:.4f} at the config's factor; serving "
                 f"checks at capacity_factor = n_experts: "
                 f"{r['serve_bf16_excluded']} bf16 positions routed unlike "
                 f"the f32 forward left out, f32 decode vs forward "
                 f"{r['serve_f32_flipped']} routed or kept differently (the "
                 f"largest margin at a flip {r['serve_f32_worst']:.3e}), "
                 f"{r['serve_f32_near']} under the margin, "
                 f"{r['serve_f32_left_out']} positions from a flip on left "
                 f"out of the f32 step check")
    return line


def family_phases(lm, seq, hubert_frames, serving):
    """Phases 19-22: llama4 (MoE), deepseek (MLA, the dense first layer,
    MoE top-6), the VLM (cross-attention) and HuBERT (the audio frontend),
    each at full width and the depth of its constants."""
    lm("llama4", model_phase, batch=LLAMA4_BATCH, seq=seq, name="llama4",
       arch=LLAMA4_ARCH, n_layers=LLAMA4_LAYERS, tag=19, **serving)
    lm("deepseek", model_phase, batch=DEEPSEEK_BATCH, seq=seq,
       name="deepseek", arch=DEEPSEEK_ARCH, n_layers=DEEPSEEK_LAYERS,
       tag=20, **serving)
    lm("vision", model_phase, batch=VISION_BATCH, seq=seq, name="vision",
       arch=VISION_ARCH, n_layers=VISION_LAYERS, tag=21, serving="steps",
       **serving)
    lm("hubert", model_phase, batch=HUBERT_BATCH, seq=hubert_frames,
       name="hubert", arch=HUBERT_ARCH, tag=22, serving=None)


# ---------------------------------------------------------------------------
# phase 23: training through the port's train() entry point
# ---------------------------------------------------------------------------
TRAIN_LR = 1e-3                # tests/test_train_integration.py's lr
TRAIN_STEPS = 20
# (arch, batch, seq): full width and depth, remat on (the configs'
# default), bf16 parameters, the pipeline's batches
TRAIN_RUNS = (("qwen2_0_5b", 2, 2048), ("rwkv6_3b", 2, 2048),
              ("recurrentgemma_2b", 2, 2048))
TRAIN_EXPECT = {"qwen2_0_5b": (),
                "rwkv6_3b": ("rwkv6_scan", "rwkv6_scan_bwd"),
                "recurrentgemma_2b": ("rglru_scan", "rglru_scan_bwd")}
# the backward kernels' checks: RecurrentGemma's scoring and serving
# shapes, RWKV-6 3B's scoring and serving shapes, a decode-sized S < 16
# and a head of 16 (of rwkv6_scan_bwd's row groups of a cluster, only the
# first holds live rows)
RGLRU_BWD_SHAPES = ((1, RG_SEQ, RG_D_RNN), (SERVE_BATCH, SERVE_PROMPT,
                                            RG_D_RNN))
RWKV_BWD_SHAPES = ((RWKV_BATCH, RWKV_SEQ, 40, 64),
                   (SERVE_BATCH, SERVE_PROMPT, 40, 64), (2, 9, 40, 64),
                   (2, 300, 40, 16))
# rwkv6_scan_bwd's largest error over its six gradients against the f64
# plain backward, in units of the f32 plain backward's own (both sum in
# f32, in other orders)
BWD_NOISE_RATIO = 2.0
# (c): f32 copies at full width, this many layers, B x S tokens (S not a
# multiple of the backward's chunk, ops.BWD_CHUNK)
GRAD_LAYERS = {"rwkv6_3b": 2, "recurrentgemma_2b": 3}
GRAD_BATCH, GRAD_SEQ = 2, 300
GRAD_NOISE_RATIO = 4.0
# a floor under that noise: a few f32 ulp of the largest gradient (RG-LRU's
# plain and exact scans are one recurrence, so their paths can coincide)
GRAD_FLOOR = 2.0 ** -20
# (d): a crash and restart of Qwen2-0.5B at full width: one checkpoint
# before the crash (label 3), the final one after the restart (4.9 GB
# each: bf16 weights and f32 moments)
RESTART = dict(steps=4, ckpt_every=2, fail_at_step=3, batch=2, seq=512)
RESTART_RTOL = 2e-3
FLOP_BWD_RWKV = 18             # a state element a step: see rwkv6_scan_bwd.cu
# (f): the other families at full width, 10 steps of the pipeline's
# batches each; (arch, batch, seq[, layers]): with ``layers`` the depth is
# cut (the prefix and 7 MoE layers; 2 periods of 5) and the rows run
# train()'s step in cut_train(), whose loop is train()'s
FAMILY_TRAIN_STEPS = 10
FAMILY_TRAIN_RUNS = (("hubert_xlarge", 2, 2048),
                     ("deepseek_v2_lite_16b", 2, 2048, DEEPSEEK_LAYERS),
                     ("llama_3_2_vision_11b", 2, 2048, VISION_LAYERS))
TRAIN_BYTES_PER_PARAM = 12     # bf16 weights and gradients, f32 moments
DEVICE_BYTES = 80e9            # the H100's memory
# (g): attn_remat on the card.  Qwen2-0.5B, batch 1, one timed train step
# a point, period remat on; the long point flag on only, and under --train
# only (its step takes minutes: PERF.md §6, PR 27)
REMAT_SEQS = (4096, 8192, 16384)
# the full run's cut of this phase (``--train`` runs all of it): 10 steps
# a main model, 8 a family, the sweep's first point and no profiled step,
# so that the full run ends well inside its 1,200 s on a slow host
# (PERF.md §6)
RUN_TRAIN_STEPS = 10
RUN_FAMILY_TRAIN_STEPS = 8
RUN_REMAT_SEQS = REMAT_SEQS[:1]
REMAT_LONG = 32768
REMAT_BIT = (2, 2048)          # batch, seq of the bit-equality check
# deepseek as an f32 copy, the prefix and 2 MoE layers: its MoE backward
# accumulates with atomics on the card, so the flag on is held within
# REMAT_SPREAD_RATIO x the spread of two runs with the flag off (a third
# draw of the same noise), not bit for bit
REMAT_SPREAD_LAYERS = 3
REMAT_SPREAD_RATIO = 2.0


def _rel(torch, got, want):
    """max|got - want| / max|want| in f64 (0 for empty tensors)."""
    if not want.numel():
        return 0.0
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))


def _grads_rel(torch, got, want):
    return max(_rel(torch, g, w) for g, w in zip(got, want))


def bwd_bounds(kind, shape, itemsize):
    """The least time of one backward: the bytes it must move (each input
    read once, each output written once) over 3.35 TB/s against its f32
    FLOP.  RWKV-6: r, k, v in ``itemsize`` bytes, w and dy read and dr,
    dk, dv, dw written in f32, state0 and dS_T read and dstate0 written,
    u read and du written; ``FLOP_BWD_RWKV`` FLOP a state element a step,
    as 3xTF32 on the tensor cores (495 / 3 TFLOP/s, the forward's rate).
    RG-LRU: a, dhs, hs read and da, db written in f32, h0 and dh_T read
    and dh0 written; 3 FLOP an element on the CUDA cores.  Returns (ms,
    by, FLOP, bytes)."""
    if kind == "rwkv6_scan_bwd":
        B, S, H, hd = shape
        n = B * S * H * hd
        nbytes = (3 * itemsize * n + 24 * n + 12 * B * H * hd * hd
                  + 8 * H * hd)
        flop = FLOP_BWD_RWKV * B * S * H * hd * hd
        rate = TF32_OPS_PER_S / 3
    else:
        B, S, R = shape
        nbytes = 20 * B * S * R + 12 * B * R
        flop = 3 * B * S * R
        rate = F32_OPS_PER_S
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flop / rate * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms
            else "operations", flop, nbytes)


def _autograd(torch, fn, ins, outs_grad):
    leaves = [x.detach().clone().requires_grad_(True) for x in ins]
    return torch.autograd.grad(fn(*leaves), leaves, outs_grad)


def scan_bwd_phase(torch, dev, seed, rglru_shapes, rwkv_shapes, timing):
    """(a) ``rglru_scan_bwd`` and ``rwkv6_scan_bwd`` against their plain
    backwards on seeded inputs (decays near 0 and near 1: RG-LRU's a and
    RWKV-6's w = exp(-exp(U(-7, 3))) and exp(-exp(U(-6, 2))); nonzero
    h0 / state0 and final-state gradients): ``rglru_scan_bwd`` bit for
    bit; ``rwkv6_scan_bwd`` (bf16 r, k, v at every shape, f32 too below
    the first) within BWD_NOISE_RATIO x the f32 plain backward's own
    error against the plain backward run in f64.  Below the first shape
    each is also held to autograd through a forward: RG-LRU's plain one
    (bit for bit), RWKV-6's exact scan (``ref.py``; the chunked plain
    form's decay domain excludes these w).  Then at each kind's first two
    shapes the kernel's ms, the plain version's, the bound
    (:func:`bwd_bounds`) and the scratch; no PyTorch call computes either
    reverse recurrence, so no library yardstick."""
    from repro_torch.kernels.linear_scan import ops
    from repro_torch.kernels.linear_scan.ref import rwkv6_reference

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 23)
    rec = {"rglru_scan_bwd": {"checked": 0, "max_abs_err": 0.0},
           "rwkv6_scan_bwd": {"checked": 0, "max_abs_err": 0.0,
                              "worst_ratio": 0.0, "autograd_ratio": 0.0}}

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rg = rec["rglru_scan_bwd"]
    timed = {}
    for i, (B, S, R) in enumerate(rglru_shapes):
        a = torch.exp(-torch.exp(rand(B, S, R) * 10.0 - 7.0))
        b, dhs = randn(B, S, R), randn(B, S, R)
        h0, dhT = randn(B, R), randn(B, R)
        hs, _ = ops.rglru_scan(a, b, h0)
        got = ops.rglru_scan_bwd(a, h0, hs, dhs, dhT)
        wants = [("plain", ops.rglru_scan_bwd_plain(a, h0, hs, dhs, dhT))]
        if i:
            wants.append(("autograd", _autograd(
                torch, ops.rglru_scan_plain, (a, b, h0), (dhs, dhT))))
        for what, want in wants:
            for g, w in zip(got, want):
                e = float((g - w).abs().max()) if g.numel() else 0.0
                rg["max_abs_err"] = max(rg["max_abs_err"], e)
                check(torch.equal(g, w), f"rglru_scan_bwd {(B, S, R)}: not "
                      f"bit-equal to the {what} backward (max_abs_err {e})")
        rg["checked"] += 1
        timed.setdefault("rglru_scan_bwd", []).append((a, h0, hs, dhs, dhT))
        del b, got, wants
    r6 = rec["rwkv6_scan_bwd"]
    for i, (B, S, H, hd) in enumerate(rwkv_shapes):
        for dt in (torch.bfloat16,) if not i else (torch.bfloat16,
                                                   torch.float32):
            shape = (B, S, H, hd)
            r, k, v = (randn(*shape).to(dt) for _ in range(3))
            w = torch.exp(-torch.exp(rand(*shape) * 8.0 - 6.0))
            u, s0 = randn(H, hd), randn(B, H, hd, hd)
            dy, dsT = randn(*shape), randn(B, H, hd, hd)
            ins = (r, k, v, w, u, s0, dy, dsT)
            got = ops.rwkv6_scan_bwd(*ins)
            p32 = ops.rwkv6_scan_bwd_plain(*ins)
            p64 = ops.rwkv6_scan_bwd_plain(*(x.double() for x in ins))
            err, noise = (_grads_rel(torch, got, p64),
                          _grads_rel(torch, p32, p64))
            what = f"rwkv6_scan_bwd {shape} {str(dt)[6:]}"
            check(err <= BWD_NOISE_RATIO * noise, f"{what}: {err:.3e} of "
                  f"max|grad| off the f64 plain backward, the f32 plain "
                  f"backward {noise:.3e} (limit {BWD_NOISE_RATIO}x)")
            r6["worst_ratio"] = max(r6["worst_ratio"], err / noise)
            r6["max_abs_err"] = max(r6["max_abs_err"], max(
                float((g - p).abs().max()) for g, p in zip(got, p32)))
            del p32
            if i:
                ag = _autograd(torch, rwkv6_reference, (r, k, v, w, u, s0),
                               (dy, dsT))
                e_ag = _grads_rel(torch, got, ag)
                n_ag = noise + _grads_rel(torch, ag, p64)
                check(e_ag <= BWD_NOISE_RATIO * n_ag, f"{what}: {e_ag:.3e} "
                      f"off autograd through the exact scan (limit "
                      f"{BWD_NOISE_RATIO} x {n_ag:.3e})")
                r6["autograd_ratio"] = max(r6["autograd_ratio"], e_ag / n_ag)
                del ag
            r6["checked"] += 1
            if dt == torch.bfloat16 and i < 2:
                timed.setdefault("rwkv6_scan_bwd", []).append(ins)
            del got, p64
    if not timing:
        return rec
    for name, fn, plain in (
            ("rglru_scan_bwd", ops.rglru_scan_bwd, ops.rglru_scan_bwd_plain),
            ("rwkv6_scan_bwd", ops.rwkv6_scan_bwd,
             ops.rwkv6_scan_bwd_plain)):
        r = rec[name]
        for j, args in enumerate(timed[name]):
            p = "" if not j else "serve_"
            shape = tuple(args[0].shape)
            r[p + "shape"] = list(shape)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn(*args)
            torch.cuda.synchronize()
            r[p + "peak_bytes"] = torch.cuda.max_memory_allocated() - base
            r[p + "ms"] = _per_call_ms(torch, lambda: fn(*args), 5, 5,
                                       hold=True)
            r[p + "plain_ms"] = _per_call_ms(torch, lambda: plain(*args), 1,
                                             1, hold=False)
            (r[p + "bound_ms"], r[p + "bound_by"], r[p + "flop"],
             r[p + "bytes"]) = bwd_bounds(name, shape,
                                          args[0].element_size())
        r["library_ms"] = None
        if name == "rwkv6_scan_bwd":
            B, S, H, _ = r["shape"]
            r["scratch_bytes"] = ops.rwkv6_scan_bwd_scratch_bytes(B, S, H)
    return rec


def _profile_step(torch, dev, cfg, params, batch, seq, seed):
    """One warm train step of ``cfg`` (``params``: fresh weights) under
    the profiler (:func:`profile_once`)."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.optim import adamw_init

    opt = adamw_init(params)
    step = make_train_step(cfg, lr=TRAIN_LR)
    tb = device_batch(cfg, make_pipeline(cfg.vocab, seq, batch,
                                         seed=seed).global_batch(0), 0,
                      seed, dev)
    step(params, opt, tb)
    return profile_once(torch, lambda: step(params, opt, tb), top=6)


def cut_train(torch, dev, cfg, *, steps, batch, seq, seed):
    """``train()``'s loop for a config whose depth is cut (``train()``
    keeps the reference's signature, which has no depth argument): fresh
    weights from ``seed``, ``make_train_step``, the pipeline's prefetch
    thread and ``device_batch``, the loss fetched each step.  Returns
    ``train()``'s metrics."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    params = transformer.model_init(seed, cfg, device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr=TRAIN_LR)
    losses, times = [], []
    it = make_pipeline(cfg.vocab, seq, batch, seed=seed).prefetch(0)
    try:
        for step in range(steps):
            tb = device_batch(cfg, next(it), step, seed, dev)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, tb)
            losses.append(float(m["loss"].float()))
            times.append(time.perf_counter() - t0)
    finally:
        it.close()
    step_s = float(np.median(times[1:] if len(times) > 1 else times))
    return dict(final_loss=losses[-1], first_loss=losses[0], steps=steps,
                loss_drop=losses[0] - losses[-1], step_ms=step_s * 1e3,
                tokens_per_s=batch * seq / step_s)


def train_runs(torch, dev, seed, counters, runs, steps, reduced, out,
               profile=True):
    """(b), (f) For each model of ``runs`` (full width, and full depth
    unless ``reduced`` or the run names its layers, remat and attn_remat
    as the config sets them, bf16 parameters, lr TRAIN_LR) ``train()``,
    or :func:`cut_train` for a cut depth, with every launch count set to 0
    just before and read just after: each loss falls from the first step
    to the last, each of the model's scan kernels (forward and backward)
    launched and ``flash_attention`` not (training runs ``xla_chunked``,
    as the reference's trainer); then one more step of fresh weights under
    the profiler (unless ``profile`` is false).  The parameter count and
    TRAIN_BYTES_PER_PARAM bytes each are reckoned against the card's
    memory."""
    from repro_torch.launch.train import train
    from repro_torch.models import transformer

    res = {"launches": dict.fromkeys(counters, 0), "models": {}}
    for arch, batch, seq, *cut in runs:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = _model_cfg(arch, reduced, **(
            {"n_layers": cut[0]} if cut else {}))
        t0 = time.perf_counter()
        fn = ((lambda: cut_train(torch, dev, cfg, steps=steps, batch=batch,
                                 seq=seq, seed=seed)) if cut else
              (lambda: train(arch, steps=steps, reduced=reduced, batch=batch,
                             seq=seq, lr=TRAIN_LR, seed=seed, log_every=10,
                             device=dev)))
        m, launches = counted(torch, dev, f"train {arch}", counters,
                              TRAIN_EXPECT.get(arch, ()), fn)
        check(launches["flash_attention"] == 0, f"train {arch}: training "
              f"launched flash_attention, which has no backward")
        check(math.isfinite(m["final_loss"]) and m["loss_drop"] > 0,
              f"train {arch}: the loss did not fall ({m['first_loss']} -> "
              f"{m['final_loss']})")
        for k, n in launches.items():
            res["launches"][k] += n
        m["launches"] = launches
        m["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                     if dev.type == "cuda" else None)
        m["seconds"] = time.perf_counter() - t0
        m["batch"], m["seq"] = batch, seq
        m["n_layers"] = cfg.n_layers
        params = transformer.model_init(seed, cfg, device=dev)
        m["params"] = transformer.count_params(params)
        m["bytes_reckoned"] = TRAIN_BYTES_PER_PARAM * m["params"]
        m["profile"] = (_profile_step(torch, dev, cfg, params, batch, seq,
                                      seed)
                        if dev.type == "cuda" and profile else None)
        del params
        res["models"][arch] = m
        pr = m["profile"]
        out(f"train: {arch} ({cfg.n_layers} layers"
            + (f" of {_model_cfg(arch, reduced).n_layers}, train()'s step"
               if cut else "")
            + f", {m['params']} params: {TRAIN_BYTES_PER_PARAM} bytes each "
            f"{m['bytes_reckoned']} of {DEVICE_BYTES:.0f}; batch {batch} x "
            f"seq {seq}, {steps} steps, lr {TRAIN_LR}, remat {cfg.remat}, "
            f"attn_remat {cfg.attn_remat}): loss "
            f"{m['first_loss']:.6f} -> {m['final_loss']:.6f}, step "
            f"{m['step_ms']:.3f} ms (median), {m['tokens_per_s']:.1f} "
            f"{'frames' if cfg.audio_frontend else 'tokens'}/s, "
            f"max_memory_allocated {m['max_memory_allocated']}, "
            f"kernel launches {_nonzero(launches) or 'none'}"
            + ("" if pr is None else
               f"; one profiled step: {pr['wall_ms']:.3f} ms wall, "
               f"{pr['device_ms']:.3f} ms of device time (busy share "
               f"{pr['busy_share']:.4f}), {pr['launches']} launches; "
               "busiest: " + "; ".join(f"{k} {ms:.3f} ms x {n}"
                                      for k, ms, n in pr["top"])
               + "; hand-written: " + ("; ".join(
                   f"{k} {ms:.3f} ms x {n}"
                   for k, (ms, n) in pr["ours"].items()) or "none"))
            + f" ({m['seconds']:.1f} s)")
    return res


def remat_sweep(torch, dev, seed, seqs, long_seq, reduced):
    """(g) Qwen2-0.5B (period remat on), one train step of batch 1 at each
    S of ``seqs`` with ``attn_remat`` on and off, and at ``long_seq`` on:
    one warm step a flag at the first S (every S runs the same chunk-pair
    shapes), then one timed step a point (the loss fetched), the peak
    memory counted afresh.  Returns one record a point: S, the flag, step
    ms, ``max_memory_allocated`` and the memory allocated before the step
    (the weights and the moments)."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    cfg0 = _model_cfg(MODEL_ARCH, reduced, remat=True)
    params = transformer.model_init(seed, cfg0, device=dev)
    opt = adamw_init(params)

    def step_at(S, flag):
        cfg = cfg0.with_(attn_remat=flag)
        tb = device_batch(cfg, make_pipeline(cfg.vocab, S, 1, seed=seed)
                          .global_batch(0), 0, seed, dev)
        return make_train_step(cfg, lr=TRAIN_LR), tb

    for flag in (True, False):
        step, tb = step_at(seqs[0], flag)
        float(step(params, opt, tb)[2]["loss"])
    points = [(S, flag) for S in seqs for flag in (True, False)]
    points += [(long_seq, True)] if long_seq else []
    rows = []
    for S, flag in points:
        step, tb = step_at(S, flag)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else None
        t0 = time.perf_counter()
        loss = float(step(params, opt, tb)[2]["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        check(math.isfinite(loss), f"attn_remat S {S}: loss {loss}")
        rows.append(dict(seq=S, attn_remat=flag, step_ms=ms, base=base,
                         peak=(torch.cuda.max_memory_allocated()
                               if dev.type == "cuda" else None)))
        del tb
    return rows


def _tree_equal(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def remat_checks(torch, dev, seed, bit, spread_layers, reduced):
    """(g) The flag on against the flag off (period remat on): Qwen2-0.5B
    at ``bit`` = (batch, seq), the loss and every gradient bit for bit
    (and whether two runs with the flag off are); deepseek as an f32 copy
    at full width, ``spread_layers`` deep, within REMAT_SPREAD_RATIO x the
    spread of two runs with the flag off (the loss and the worst gradient
    leaf, each relative to its max|g|; at least GRAD_FLOOR)."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer
    from repro_torch.optim.tree import leaves

    def batch_of(cfg):
        return device_batch(cfg, make_pipeline(cfg.vocab, bit[1], bit[0],
                                               seed=seed).global_batch(0),
                            0, seed, dev)

    out = {}
    cfg = _model_cfg(MODEL_ARCH, reduced, remat=True)
    params = transformer.model_init(seed, cfg, device=dev)
    tb = batch_of(cfg)
    l0, g0 = loss_and_grads(params, cfg.with_(attn_remat=False), tb)
    l1, g1 = loss_and_grads(params, cfg.with_(attn_remat=True), tb)
    g0, g1 = leaves(g0), leaves(g1)
    equal = bool(torch.equal(l0, l1)) and _tree_equal(torch, g0, g1)
    del g1
    l2, g2 = loss_and_grads(params, cfg.with_(attn_remat=False), tb)
    rerun = bool(torch.equal(l0, l2)) and _tree_equal(torch, g0, leaves(g2))
    out["qwen2"] = dict(equal=equal, rerun_equal=rerun, leaves=len(g0),
                        loss=float(l0), bit=bit)
    check(equal, f"attn_remat: Qwen2-0.5B's loss or gradients with the flag "
          f"on differ from the flag off (two runs with the flag off "
          f"{'are' if rerun else 'are not'} bit-equal)")
    del params, g0, g2

    cfg = _f32_cfg(_model_cfg(DEEPSEEK_ARCH, reduced, remat=True,
                              n_layers=spread_layers))
    params = _upcast(transformer.model_init(seed, cfg, device=dev))
    tb = batch_of(cfg)
    l0, g0 = loss_and_grads(params, cfg.with_(attn_remat=False), tb)
    g0 = leaves(g0)
    l2, g2 = loss_and_grads(params, cfg.with_(attn_remat=False), tb)
    spread = _grads_rel(torch, leaves(g2), g0)
    del g2
    l1, g1 = loss_and_grads(params, cfg.with_(attn_remat=True), tb)
    err = _grads_rel(torch, leaves(g1), g0)
    loss_spread = abs(float(l2) - float(l0))
    loss_err = abs(float(l1) - float(l0))
    limit = REMAT_SPREAD_RATIO * max(spread, GRAD_FLOOR)
    loss_limit = REMAT_SPREAD_RATIO * max(
        loss_spread, float(np.finfo(np.float32).eps) * abs(float(l0)))
    out["deepseek"] = dict(layers=cfg.n_layers, leaves=len(g0), err=err,
                           spread=spread, limit=limit, loss=float(l0),
                           loss_err=loss_err, loss_spread=loss_spread,
                           loss_limit=loss_limit)
    check(err <= limit and loss_err <= loss_limit,
          f"attn_remat: deepseek's gradients with the flag on {err:.3e} of "
          f"max|g| off the flag off (limit {limit:.3e}: two runs with the "
          f"flag off {spread:.3e} apart), the loss {loss_err:.3e} (limit "
          f"{loss_limit:.3e})")
    del params, g0, g1
    return out


def remat_line(rows, chk, seconds):
    d, q = chk["deepseek"], chk["qwen2"]
    mib = 2 ** 20
    return ("train: attn_remat, Qwen2-0.5B one train step of batch 1, "
            "period remat on: " + "; ".join(
                f"S {r['seq']} flag {'on' if r['attn_remat'] else 'off'} "
                f"{r['step_ms']:.3f} ms, max_memory_allocated {r['peak']}"
                + ("" if r["peak"] is None else
                   f" ({(r['peak'] - r['base']) / mib:.1f} MiB above the "
                   f"{r['base']} before the step)")
                for r in rows)
            + f"; flag on == flag off bit for bit on Qwen2-0.5B at "
            f"{q['bit'][0]} x {q['bit'][1]} (loss {q['loss']:.6f} and "
            f"{q['leaves']} gradient leaves; two runs with the flag off "
            f"bit-equal: {q['rerun_equal']}); deepseek f32 copy, "
            f"{d['layers']} layers, {d['leaves']} leaves: flag on vs off "
            f"worst leaf {d['err']:.3e} of max|g| (two runs with the flag "
            f"off {d['spread']:.3e}, limit {d['limit']:.3e}), loss "
            f"{d['loss']:.6f} |diff| {d['loss_err']:.3e} (spread "
            f"{d['loss_spread']:.3e}, limit {d['loss_limit']:.3e}); the "
            f"MoE backward accumulates with atomics, so bit-equality is not "
            f"promised there ({seconds:.1f} s)")


def grad_check(torch, dev, seed, layers, batch, seq, reduced):
    """(c) For each recurrent model, an f32 copy at full width (``layers``
    deep; RG-LRU's ``lam`` redrawn, :func:`slow_decay`): one step's loss
    and every gradient leaf through the kernels (forward and backward)
    against the plain path (:func:`plain_scans`), within GRAD_NOISE_RATIO
    x the plain path's own noise: the larger of the distance of the two
    plain f32 paths (the chunked plain scan and the exact one,
    ``plain_scans(exact=True)``), of two runs of the plain path (CUDA's
    embedding backward sums with atomics) and GRAD_FLOOR; each leaf
    relative to its max|g|, the worst leaf against the worst."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer
    from repro_torch.optim.tree import leaves

    out = {}
    for arch, n_layers in layers.items():
        cfg = _model_cfg(arch, reduced, n_layers=n_layers)
        params = _upcast(transformer.model_init(seed, cfg, device=dev))
        slow_decay(torch, params, seed)
        tb = device_batch(cfg, make_pipeline(cfg.vocab, seq, batch,
                                             seed=seed).global_batch(0),
                          0, seed, dev)
        lk, gk = loss_and_grads(params, cfg, tb)
        with plain_scans():
            lp, gp = loss_and_grads(params, cfg, tb)
            _, gp2 = loss_and_grads(params, cfg, tb)
        with plain_scans(exact=True):
            le, ge = loss_and_grads(params, cfg, tb)
        gk, gp, gp2, ge = leaves(gk), leaves(gp), leaves(gp2), leaves(ge)
        err = _grads_rel(torch, gk, gp)
        noise = _grads_rel(torch, ge, gp)
        rerun = _grads_rel(torch, gp2, gp)
        limit = GRAD_NOISE_RATIO * max(noise, rerun, GRAD_FLOOR)
        check(err <= limit, f"grads {arch}: the kernel path's gradients "
              f"{err:.3e} of max|g| off the plain path's (limit "
              f"{limit:.3e}: the two plain paths {noise:.3e} apart, two "
              f"plain runs {rerun:.3e})")
        out[arch] = dict(layers=cfg.n_layers, leaves=len(gk), err=err,
                         noise=noise, rerun=rerun, limit=limit,
                         loss=float(lk), plain_loss=float(lp),
                         exact_loss=float(le))
        del params, gk, gp, gp2, ge
    return out


def restart_check(torch, dev, seed, reduced):
    """(d) Qwen2-0.5B through ``train()`` with a checkpoint directory (a
    temporary one under ``build/``): crash at step
    ``RESTART["fail_at_step"]``, resume from the last checkpoint and end
    within RESTART_RTOL of an uninterrupted run's final loss (CUDA's
    embedding backward sums with atomics, so the two runs' gradients
    differ in their last bits; on the CPU the match is exact)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import train

    kw = dict(RESTART)
    fail = kw.pop("fail_at_step")
    t0 = time.perf_counter()
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_",
                                     dir=base) as tmp:
        free = shutil.disk_usage(tmp).free
        d = str(Path(tmp) / "ck")
        common = dict(reduced=reduced, lr=TRAIN_LR, seed=seed,
                      log_every=100, device=dev, **kw)
        t1 = time.perf_counter()
        try:
            train(MODEL_ARCH, ckpt_dir=d, fail_at_step=fail, **common)
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError("restart: the simulated crash did not "
                                 "happen")
        crashed_s = time.perf_counter() - t1
        resume = latest_step(d)
        check(resume is not None and resume < kw["steps"],
              f"restart: no checkpoint to resume from ({resume})")
        t1 = time.perf_counter()
        m1 = train(MODEL_ARCH, ckpt_dir=d, **common)
        resumed_s = time.perf_counter() - t1
        ckpt_bytes = sum(f.stat().st_size
                         for f in (Path(d) / f"step_{kw['steps']:010d}")
                         .iterdir())
    m2 = train(MODEL_ARCH, **common)
    diff = abs(m1["final_loss"] - m2["final_loss"])
    limit = RESTART_RTOL * abs(m2["final_loss"]) if dev.type == "cuda" \
        else 0.0
    check(diff <= limit, f"restart: resumed final loss {m1['final_loss']} "
          f"vs uninterrupted {m2['final_loss']} (limit {limit})")
    return dict(resume=resume, final=m1["final_loss"],
                clean=m2["final_loss"], diff=diff, limit=limit,
                crashed_s=crashed_s, resumed_s=resumed_s,
                ckpt_bytes=ckpt_bytes, free=free,
                seconds=time.perf_counter() - t0)


def refusal_check(torch, dev):
    """(e) ``flash_attention`` under grad raises, on the card as on the
    host, and without grad still launches."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (torch.randn((1, 128, 2, 64), device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    try:
        flash_attention(q.requires_grad_(True), k, v)
    except RuntimeError as e:
        check("no backward" in str(e), f"refusal: {e}")
    else:
        raise AssertionError("flash_attention returned a result under grad")
    with torch.no_grad():
        o = flash_attention(q, k, v)
    check(o.shape == q.shape and bool(torch.isfinite(o.float()).all()),
          "flash_attention without grad")
    return True


def train_phase(torch, dev, seed, counters, *, runs=TRAIN_RUNS,
                steps=TRAIN_STEPS, rglru_shapes=RGLRU_BWD_SHAPES,
                rwkv_shapes=RWKV_BWD_SHAPES, grad_layers=GRAD_LAYERS,
                grad_batch=GRAD_BATCH, grad_seq=GRAD_SEQ,
                family_runs=FAMILY_TRAIN_RUNS,
                family_steps=FAMILY_TRAIN_STEPS, remat_seqs=REMAT_SEQS,
                remat_long=REMAT_LONG, remat_bit=REMAT_BIT,
                spread_layers=REMAT_SPREAD_LAYERS, reduced=False,
                profile=True, timing=True, out=print):
    """Phase 23: (a) :func:`scan_bwd_phase`, (b) and (f)
    :func:`train_runs` (the launches of both counted as the ``train``
    path's), (g) :func:`remat_sweep` and :func:`remat_checks`, (c)
    :func:`grad_check`, (d) :func:`restart_check`, (e)
    :func:`refusal_check`; one line each.  Returns the records."""
    t0 = time.perf_counter()
    rec = {"bwd": scan_bwd_phase(torch, dev, seed, rglru_shapes,
                                 rwkv_shapes, timing and dev.type == "cuda")}
    out(bwd_line(rec["bwd"], time.perf_counter() - t0))
    rec["train"] = train_runs(torch, dev, seed, counters, runs, steps,
                              reduced, out, profile=profile)
    fam = train_runs(torch, dev, seed, counters, family_runs, family_steps,
                     reduced, out, profile=profile)
    rec["train"]["models"].update(fam["models"])
    for k, n in fam["launches"].items():
        rec["train"]["launches"][k] += n
    t1 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["remat"] = remat_sweep(torch, dev, seed, remat_seqs, remat_long,
                               reduced)
    rec["remat_checks"] = remat_checks(torch, dev, seed, remat_bit,
                                       spread_layers, reduced)
    out(remat_line(rec["remat"], rec["remat_checks"],
                   time.perf_counter() - t1))
    t1 = time.perf_counter()
    rec["grads"] = grad_check(torch, dev, seed, grad_layers, grad_batch,
                              grad_seq, reduced)
    out("train: gradients, kernel path vs plain path (f32 copies at full "
        "width, " + "; ".join(
            f"{a} {g['layers']} layers, {g['leaves']} leaves: worst leaf "
            f"{g['err']:.3e} of max|g| (limit {g['limit']:.3e}: the two "
            f"plain paths {g['noise']:.3e}, two plain runs {g['rerun']:.3e}"
            f"), loss {g['loss']:.6f} vs plain "
            f"{g['plain_loss']:.6f} / exact {g['exact_loss']:.6f}"
            for a, g in rec["grads"].items())
        + f"; {grad_batch} x {grad_seq} tokens) "
        f"({time.perf_counter() - t1:.1f} s)")
    r = rec["restart"] = restart_check(torch, dev, seed, reduced)
    out(f"train: crash and restart ({MODEL_ARCH}, {RESTART}): resumed from "
        f"step {r['resume']}, final loss {r['final']:.6f} vs uninterrupted "
        f"{r['clean']:.6f} (|diff| {r['diff']:.3e}, limit {r['limit']:.3e}); "
        f"the crashed run {r['crashed_s']:.1f} s, the resumed one "
        f"{r['resumed_s']:.1f} s, a checkpoint {r['ckpt_bytes']} bytes, "
        f"{r['free']} bytes free ({r['seconds']:.1f} s)")
    refusal_check(torch, dev)
    out(f"train: flash_attention under grad raises, without grad runs; "
        f"train phase {time.perf_counter() - t0:.1f} s")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def bwd_line(rec, seconds):
    rg, r6 = rec["rglru_scan_bwd"], rec["rwkv6_scan_bwd"]
    line = (f"kernels: rglru_scan_bwd == plain backward bit for bit on "
            f"{rg['checked']} launches (and == autograd through the plain "
            f"forward below the first shape); rwkv6_scan_bwd on "
            f"{r6['checked']} launches within {BWD_NOISE_RATIO}x the f32 "
            f"plain backward's error against f64 (worst ratio "
            f"{r6['worst_ratio']:.3f}; vs autograd through the exact scan "
            f"{r6['autograd_ratio']:.3f}), max_abs_err vs plain "
            f"{r6['max_abs_err']} ({seconds:.1f} s)")
    if "ms" not in rg:
        return line + "; timing not measured"
    for name, r in rec.items():
        line += f"; {name}: " + ", ".join(
            f"{r[p + 'shape']} ms {r[p + 'ms']:.6f} plain_ms "
            f"{r[p + 'plain_ms']:.6f} bound_ms {r[p + 'bound_ms']:.6f} "
            f"({r[p + 'bound_by']}: {r[p + 'bytes']} bytes, "
            f"{r[p + 'flop']:.4e} FLOP) peak {r[p + 'peak_bytes']} bytes"
            for p in ("", "serve_")) + " library_ms None"
    return line + (f"; rwkv6_scan_bwd scratch at {r6['shape']}: "
                   f"{r6['scratch_bytes']} bytes")


# ---------------------------------------------------------------------------
# placement: the mesh twins (DESIGN.md §18) on a one-rank NCCL group
# ---------------------------------------------------------------------------
PLACE_K = 4                    # the pq-sharded, map and sketch phases' K
PLACE_MAP_BATCHES = 60         # the map twins' seeded batches
PLACE_GRAPH_BATCHES = 30       # the graph twins' seeded batches
PLACE_ROUND_LISTS = 12         # mixed_rounds lists of up to PLACE_ROWS rows
PLACE_ROWS = 8
PLACE_COLL_CALLS = 50          # collectives timed a kind (CUDA events)
PLACE_FETCH_EVERY = 20         # every 20th mesh pass runs under one_fetch


def place_mesh(dev, k=PLACE_K):
    """``MeshPlacement(make_combining_mesh(k))``: on the card a one-rank
    NCCL group over a ``FileStore`` (the world is this process)."""
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.launch.mesh import make_combining_mesh

    return MeshPlacement(make_combining_mesh(k, device=dev))


def _timed(dev, torch, fn):
    """``fn()`` and its wall seconds (synchronised on the card)."""
    t0 = time.perf_counter()
    got = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return got, time.perf_counter() - t0


def _heap_delta(counters, before, keys):
    return {k: counters[k].launches - before[k] for k in keys}


def place_pq(torch, dev, seed, pl, init, cap, counters, n_batches, threads,
             ops):
    """Part a: stacked and mesh twins of ``ShardedBatchedPQ`` from the same
    keys take the same seeded batches (the pq phases' replay mix): answers
    and the (gathered) heaps bit-equal after every batch, both equal to
    ``SequentialHeap``; the heap kernels' launches of the two twins equal;
    every 20th mesh pass under :func:`one_fetch`; then
    ``pc_sharded_priority_queue(placement=...)`` under ``threads`` clients,
    conservation and the heap property checked."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core.pc_pq import pc_sharded_priority_queue
    from repro_torch.core.seq_pq import SequentialHeap
    from repro_torch.core.sharded_pq import ShardedBatchedPQ

    twins = {"stacked": ShardedBatchedPQ(cap, C_MAX, n_shards=PLACE_K,
                                         values=init, device=dev),
             "mesh": ShardedBatchedPQ(cap, C_MAX, n_shards=PLACE_K,
                                      values=init, placement=pl)}
    st, mh = twins["stacked"], twins["mesh"]
    check(mh.state.a.shape[0] == PLACE_K // pl.n_devices
          and mh.state.a.device.type == dev.type,
          "placement pq: the mesh twin does not hold K / D rows")
    check(_heap_bits_equal(torch, st.state, mh.global_state()),
          "placement pq: twins differ at init")
    oracle = SequentialHeap()
    oracle.a = [float("-inf")] + st.values()
    rng = np.random.default_rng([seed, 40])
    secs = dict.fromkeys(twins, 0.0)
    launches = {name: dict.fromkeys(HEAP, 0) for name in twins}
    fetches = 0
    ptr = mh.state.a.data_ptr()
    for b in range(n_batches):
        w = int(rng.integers(1, C_MAX + 1))
        ne = int(rng.integers(0, w + 1))
        head = oracle.a[1] if oracle.size else 0.0
        fresh = rng.uniform(0, KEY_RANGE, w - ne).astype(np.float32)
        ins = np.where(rng.random(w - ne) < 0.25, np.float32(head),
                       fresh).tolist()
        got = {}
        for name, q in twins.items():
            before = {k: counters[k].launches for k in HEAP}
            one = (name == "mesh" and dev.type == "cuda"
                   and b % PLACE_FETCH_EVERY == PLACE_FETCH_EVERY // 2)
            if one:
                fetches += 1
            got[name], s = _timed(dev, torch, (lambda q=q: one_fetch(
                torch, bpq, lambda: q.apply(ne, ins))) if one else (
                    lambda q=q: q.apply(ne, ins)))
            secs[name] += s
            for k, v in _heap_delta(counters, before, HEAP).items():
                launches[name][k] += v
        want = [oracle.extract_min() for _ in range(ne)]
        for v in ins:
            oracle.insert(float(np.float32(v)))
        check(_bits_list(got["mesh"]) == _bits_list(got["stacked"])
              == _bits_list(want),
              f"placement pq batch {b}: mesh {got['mesh']} / stacked "
              f"{got['stacked']} / oracle {want}")
        check(_heap_bits_equal(torch, st.state, mh.global_state()),
              f"placement pq batch {b}: mesh heaps != stacked heaps")
    check(launches["mesh"] == launches["stacked"],
          f"placement pq: mesh launches {launches['mesh']} != stacked "
          f"{launches['stacked']}")
    check(mh.state.a.data_ptr() == ptr, "placement pq: the mesh twin's "
                                        "rows moved (in place expected)")
    check(sorted(oracle.a[1:]) == mh.values(),
          "placement pq: final multiset != the oracle's")
    out = {"batches": n_batches, "fetch_checked": fetches,
           "launches": launches,
           "ms_per_pass": {k: v / n_batches * 1e3 for k, v in secs.items()},
           "twins": twins}

    engine = pc_sharded_priority_queue(cap, C_MAX, n_shards=PLACE_K,
                                       values=init, placement=pl,
                                       device=dev)
    before = {k: counters[k].launches for k in HEAP}
    ins_t, ext, seconds = drive(engine, threads, ops, seed)
    thr = _heap_delta(counters, before, HEAP)
    check(all(v is not None for v in ext),
          "placement pq threads: empty-queue extract")
    lhs = np.sort(np.concatenate([init, ins_t]))
    rhs = np.sort(np.concatenate([np.array(ext, np.float32),
                                  np.array(engine.pq.values(), np.float32)]))
    check(np.array_equal(lhs, rhs),
          "placement pq threads: multiset not conserved")
    gs = engine.pq.global_state()
    a, sizes = gs.a.cpu().numpy(), gs.size.cpu().numpy()
    for k in range(PLACE_K):
        check(np.isinf(a[k, 0]) and bpq.check_heap_property(
            a[k], int(sizes[k])),
            f"placement pq threads: shard {k} violates the heap property")
    check(dev.type != "cuda" or all(thr[k] > 0 for k in HEAP),
          f"placement pq threads: heap kernels not launched: {thr}")
    out["threads"] = {"ops": threads * ops, "seconds": seconds,
                      "ops_per_s": threads * ops / seconds,
                      "passes": engine.passes,
                      "mean_batch": float(np.mean(engine.combined_sizes)),
                      "launches": thr}
    return out


def place_rounds(torch, dev, seed, twins, n_lists):
    """Part d: ``mixed_rounds`` lists of up to PLACE_ROWS rows through both
    PQ twins (stacked: one CUDA-graph replay a dispatch on the card; mesh:
    the rows eagerly, collectives and all): every handle's answers and the
    heaps bit-equal, and no graph captured on the mesh twin."""
    st, mh = twins["stacked"], twins["mesh"]
    rng = np.random.default_rng([seed, 43])
    secs = {"stacked": [], "mesh": []}
    rows = []
    for i in range(n_lists):
        rounds = mega_rounds(rng, st, PLACE_ROWS)
        rows.append(len(st._mixed_specs(rounds)[0]))
        got = {}
        for name, q in twins.items():
            got[name], s = _timed(dev, torch, lambda q=q: [
                _bits_list(h.result()) for h in q.mixed_rounds(rounds)])
            secs[name].append(s * 1e3)
        check(got["mesh"] == got["stacked"],
              f"placement rounds list {i}: mesh answers != stacked")
        check(_heap_bits_equal(torch, st.state, mh.global_state()),
              f"placement rounds list {i}: mesh heaps != stacked heaps")
    check(mh.graph_captures == 0 and mh.graph_replays == 0,
          "placement rounds: the mesh twin captured a CUDA graph")
    check(dev.type != "cuda" or st.graph_replays > 0,
          "placement rounds: the stacked twin replayed no graph")
    return {"lists": n_lists, "rows": rows,
            "stacked_graph_replays": st.graph_replays,
            "mesh_graph_captures": mh.graph_captures,
            "ms_per_dispatch": {k: float(np.median(v))
                                for k, v in secs.items()}}


def place_map(torch, dev, seed, pl, n, counters, n_batches):
    """Part b: stacked and mesh twins of ``ShardedMap`` over the map
    phase's 10⁶ keys take the same seeded batches of the bench mix
    (:func:`map_op`, 90 % reads): answers equal (``range_sum`` bit for
    bit) and the (gathered) tables bit-equal after every batch;
    ``sorted_merge``'s launches of the two twins equal; every 20th mesh
    batch under :func:`one_fetch`."""
    from repro_torch.core import batched_map as bm

    rng = np.random.default_rng([seed, 15])        # the map phase's keys
    keys = grid_keys(rng, n)
    vals = rng.uniform(0, 10, n).astype(np.float32)
    items = list(zip(keys.tolist(), vals.tolist()))
    cap = shard_capacity(n + n_batches * 3 * C_MAX + 2, PLACE_K)
    t0 = time.perf_counter()
    twins = {name: bm.ShardedMap(cap, C_MAX, n_shards=PLACE_K,
                                 key_range=MAP_KEY_RANGE, items=items, **kw)
             for name, kw in (("stacked", dict(device=dev)),
                              ("mesh", dict(placement=pl)))}
    setup_s = time.perf_counter() - t0
    st, mh = twins["stacked"], twins["mesh"]
    check(_states_bit_equal(torch, st.state, mh.global_state()),
          "placement map: twins differ at init")
    rng = np.random.default_rng([seed, 41])
    secs = dict.fromkeys(twins, 0.0)
    launches = dict.fromkeys(twins, 0)
    fetches = 0
    for b in range(n_batches):
        ops = [map_op(rng, keys, n) for _ in range(int(rng.integers(
            1, 3 * C_MAX + 1)))]
        um = [(m, i) for m, i in ops if m in bm._UPDATE_CODE]
        rm = [(m, i) for m, i in ops if m in bm._READ_CODE]
        got = {}
        for name, m in twins.items():
            before = counters["sorted_merge"].launches

            def step(m=m):
                h = m.update_batch_async([x for x, _ in um],
                                         [y for _, y in um])
                r = m.read_batch([x for x, _ in rm], [y for _, y in rm])
                return h, r

            one = (name == "mesh" and dev.type == "cuda"
                   and b % PLACE_FETCH_EVERY == PLACE_FETCH_EVERY // 2)
            if one:
                fetches += 1
            (h, r), s = _timed(dev, torch, (lambda: one_fetch(
                torch, bm, step)) if one else step)
            got[name] = (h.result(), r)
            secs[name] += s
            launches[name] += counters["sorted_merge"].launches - before
        check(got["mesh"] == got["stacked"],
              f"placement map batch {b}: mesh answers != stacked")
        check(_states_bit_equal(torch, st.state, mh.global_state()),
              f"placement map batch {b}: mesh tables != stacked tables")
    check(launches["mesh"] == launches["stacked"]
          and (dev.type != "cuda" or launches["mesh"] > 0),
          f"placement map: sorted_merge launches {launches}")
    rounds = []
    for r in range(PLACE_ROWS):
        ops = [map_op(rng, keys, n) for _ in range(C_MAX)]
        kind = "update" if r % 2 == 0 else "read"
        code = bm._UPDATE_CODE if kind == "update" else bm._READ_CODE
        ops = [(m, i) for m, i in ops if m in code]
        rounds.append((kind, [m for m, _ in ops], [i for _, i in ops]))
    got = [[h.result() for h in m.mixed_rounds(rounds)]
           for m in (st, mh)]
    check(got[0] == got[1] and _states_bit_equal(
        torch, st.state, mh.global_state()),
          "placement map: mixed_rounds mesh != stacked")
    return {"batches": n_batches, "fetch_checked": fetches,
            "launches": launches, "setup_s": setup_s, "keys": n,
            "ms_per_pass": {k: v / n_batches * 1e3
                            for k, v in secs.items()}}


def place_graph(torch, dev, seed, pl, g, tree, counters, n_batches):
    """Part c: stacked and mesh twins of ``DeviceGraph`` built from the
    state of ``g`` (the graph phase's half-populated 10⁶-vertex tree, not
    prepopulated again) take the same seeded batches — tree edges
    deleted (a full rebuild each) and inserted, 16 ``connected`` queries —
    every state field and answer bit-equal after every batch, the labels
    equal to the union-find oracle at the end; ``label_prop``'s launches
    counted a read pass (stacked: rebuild + merge, gated on the device;
    mesh: the block fixpoint, the star merge and the merge where the
    host's bound allows a rebuild, else the merge alone)."""
    from repro_torch.core import device_graph as dg
    from repro_torch.kernels.label_prop.ref import components_reference

    live = sorted(g.edges())
    twins = {}
    for name, kw in (("stacked", dict(device=dev)),
                     ("mesh", dict(placement=pl))):
        h = dg.DeviceGraph(g.n, edge_capacity=g.capacity, c_max=g.c_max,
                           n_shards=g.n_shards, **kw)
        h.state = dg.clone_state(g.state)
        h._n_edges = len(live)
        twins[name] = h
    st, mh = twins["stacked"], twins["mesh"]
    # the mesh twin's first collective starts its communicator: not timed
    mh._comm.sum(torch.zeros((), dtype=torch.int32, device=dev))
    rng = np.random.default_rng([seed, 42])
    n = g.n
    secs = dict.fromkeys(twins, 0.0)
    launches = dict.fromkeys(twins, 0)
    rebuilds = {k: h.full_rebuilds() for k, h in twins.items()}
    want_mesh = gathered = 0
    for b in range(n_batches):
        k = int(rng.integers(1, 2 * C_MAX + 1))
        ms, ins = [], []
        for _ in range(k):
            if b % 3 and rng.random() < 0.5:
                ms.append("delete")
                ins.append(live[int(rng.integers(len(live)))])
            else:
                ms.append("insert")
                ins.append(tree[int(rng.integers(len(tree)))])
        q = [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(8)]
        q += [tuple(e) for e in ins[:8]]
        # the mesh twin gathers only where its host bound allows a
        # rebuild: a delete, or the first read after its state was set
        # (at most 32 inserts never overflow the pending buffer)
        gathered += b == 0 or "delete" in ms
        want_mesh += 3 if b == 0 or "delete" in ms else 1
        got = {}
        for name, h in twins.items():
            before = counters["label_prop"].launches
            (hd, ans), s = _timed(dev, torch, lambda h=h: (
                h.update_batch_async(ms, ins), h.connected_batch(q)))
            got[name] = (hd.result(), ans)
            secs[name] += s
            launches[name] += counters["label_prop"].launches - before
        check(got["mesh"] == got["stacked"],
              f"placement graph batch {b}: mesh answers != stacked")
        check(all(torch.equal(x, y) for x, y in zip(st.state, mh.state)),
              f"placement graph batch {b}: mesh state != stacked state")
    rebuilds = {k: h.full_rebuilds() - rebuilds[k]
                for k, h in twins.items()}
    check(rebuilds["mesh"] == rebuilds["stacked"] > 0,
          f"placement graph: full rebuilds {rebuilds}")
    if dev.type == "cuda":
        check(launches["stacked"] == 2 * n_batches
              and launches["mesh"] == want_mesh,
              f"placement graph: label_prop launches {launches} over "
              f"{n_batches} read passes (want 2 a pass and {want_mesh})")
    edges = mh.edges()
    check(edges == st.edges(), "placement graph: edge sets differ")
    check(np.array_equal(np.asarray(mh.labels(), np.int32),
                         components_reference(n, sorted(edges))),
          "placement graph: labels != the union-find oracle")
    return {"batches": n_batches, "rebuilds": rebuilds["mesh"],
            "launches": launches, "gathered": gathered, "live_edges": len(edges),
            "ms_per_pass": {k: v / n_batches * 1e3
                            for k, v in secs.items()}}


def place_collectives(torch, dev, comm, calls=PLACE_COLL_CALLS):
    """Part f: one collective on a placed structure's group — ms a call
    between CUDA events around ``calls`` back-to-back calls (the stream's
    time, host gaps included), and the host's ms a call (the loop's
    enqueue), medians of 5 windows; ``None`` off the card."""
    x = torch.randn(PLACE_K, C_MAX, device=dev)
    y = torch.zeros(1, 10 ** 6, dtype=torch.int32, device=dev)
    s = torch.ones((), dtype=torch.int64, device=dev)
    out = {}
    for label, fn in (("all_gather (4, 16) f32", lambda: comm.gather(x)),
                      ("all_gather (1, 10^6) i32", lambda: comm.gather(y)),
                      ("all_reduce () i64", lambda: comm.sum(s))):
        fn()
        if dev.type != "cuda":
            out[label] = None
            continue
        ms, host = [], []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host.append((time.perf_counter() - t0) * 1e3 / calls)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1) / calls)
        out[label] = (float(np.median(ms)), float(np.median(host)))
    return out


def placement_phase(torch, dev, seed, counters, init, pq_cap, graph, *,
                    threads=THREADS, ops=OPS_PER_THREAD,
                    n_replay=REPLAY_BATCHES, map_keys=MAP_KEYS,
                    map_batches=PLACE_MAP_BATCHES,
                    graph_batches=PLACE_GRAPH_BATCHES,
                    round_lists=PLACE_ROUND_LISTS, out=print):
    """Parts a-f on a one-rank mesh: on the card an NCCL group (one card
    allows no other mesh), on the CPU gloo.  ``graph``: ``(DeviceGraph,
    tree edges)`` of the graph phase.  Returns the phase's stats, the
    launches of the whole phase under ``launches``."""
    import os

    import torch.distributed as dist

    from repro_torch.core import substrate
    from repro_torch.launch import serve

    import io

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        # the machine has no network: NCCL's bootstrap binds loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    for f in counters.values():
        f.launches = 0
    pl = place_mesh(dev)
    probe = pl.comm()
    # a new group's first collective starts its communicator
    _, start_s = _timed(dev, torch, lambda: probe.sum(
        torch.zeros((), dtype=torch.int32, device=dev)))
    backend = dist.get_backend(probe.group)
    check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
          f"placement: the mesh's group runs {backend}")
    nccl = str(torch.cuda.nccl.version()) if dev.type == "cuda" else None
    out(f"placement mesh: {pl.describe()}, ranks {pl.ranks}, device "
        f"{pl.device}, backend {backend}, NCCL {nccl}, NCCL_SOCKET_IFNAME="
        f"{os.environ.get('NCCL_SOCKET_IFNAME')}; a new group's first "
        f"collective (its communicator's start-up) {start_s * 1e3:.3f} ms")
    res = {"describe": pl.describe(), "backend": backend, "nccl": nccl,
           "group_start_ms": start_s * 1e3}

    t0 = time.perf_counter()
    p = place_pq(torch, dev, seed, pl, init, pq_cap, counters, n_replay,
                 threads, ops)
    twins = p.pop("twins")
    res["pq"] = p
    thr = p["threads"]
    out(f"placement pq: {p['batches']} seeded batches at {len(init)} keys, "
        f"K = {PLACE_K}: mesh == stacked == SequentialHeap bit for bit "
        f"(answers and gathered heaps after every batch); heap launches "
        f"mesh {p['launches']['mesh']} == stacked "
        f"{p['launches']['stacked']}; {p['fetch_checked']} mesh passes "
        f"under one_fetch (one blocking fetch each); ms a pass (wall, its "
        f"fetch included) mesh {p['ms_per_pass']['mesh']:.3f}, stacked "
        f"{p['ms_per_pass']['stacked']:.3f}; pc_sharded_priority_queue("
        f"placement=): {thr['ops_per_s']:.1f} ops/s ({thr['ops']} ops in "
        f"{thr['seconds']:.3f} s, {threads} threads), passes "
        f"{thr['passes']}, mean batch {thr['mean_batch']:.3f}, launches "
        f"{thr['launches']}, conservation and heap property ok "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    r = place_rounds(torch, dev, seed, twins, round_lists)
    res["rounds"] = r
    out(f"placement rounds: {r['lists']} mixed_rounds lists of "
        f"{r['rows']} rows: mesh == stacked bit for bit; mesh graph "
        f"captures {r['mesh_graph_captures']}, stacked graph replays "
        f"{r['stacked_graph_replays']}; ms a dispatch (wall, answers "
        f"fetched, median) mesh {r['ms_per_dispatch']['mesh']:.3f}, "
        f"stacked {r['ms_per_dispatch']['stacked']:.3f} "
        f"({time.perf_counter() - t0:.1f} s)")
    res["collectives_ms"] = place_collectives(torch, dev,
                                              twins["mesh"]._comm)
    del twins

    t0 = time.perf_counter()
    m = place_map(torch, dev, seed, pl, map_keys, counters, map_batches)
    res["map"] = m
    out(f"placement map: {m['batches']} seeded batches (bench mix, "
        f"{READ_PCT}% reads) at {m['keys']} keys, K = {PLACE_K}: mesh == "
        f"stacked bit for bit (answers, range_sum included, and gathered "
        f"tables after every batch; mixed_rounds of {PLACE_ROWS} rounds); "
        f"sorted_merge launches mesh {m['launches']['mesh']} == stacked "
        f"{m['launches']['stacked']}; {m['fetch_checked']} mesh batches "
        f"under one_fetch; ms a batch (wall) mesh "
        f"{m['ms_per_pass']['mesh']:.3f}, stacked "
        f"{m['ms_per_pass']['stacked']:.3f}; set-up {m['setup_s']:.1f} s "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    gr = place_graph(torch, dev, seed, pl, graph[0], graph[1], counters,
                     graph_batches)
    res["graph"] = gr
    out(f"placement graph: {gr['batches']} seeded batches at "
        f"{graph[0].n} vertices ({gr['live_edges']} live edges), twins "
        f"from the graph phase's state: mesh == stacked bit for bit "
        f"(answers and every GraphState field after every batch), labels "
        f"== union-find oracle; {gr['rebuilds']} full rebuilds; label_prop "
        f"launches mesh {gr['launches']['mesh']}, stacked "
        f"{gr['launches']['stacked']} (a read pass: mesh 3 where the host "
        f"bound allows a rebuild, {gr['gathered']} passes, else 1; stacked "
        f"2); ms a batch "
        f"(wall) mesh {gr['ms_per_pass']['mesh']:.3f}, stacked "
        f"{gr['ms_per_pass']['stacked']:.3f} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    runs = [(f"{w} mesh", ["--workload", w, "--scheduler", "pc-async",
                           "--mesh-shards", str(PLACE_K)])
            for w in ("pq", "map", "graph")]
    runs.append(("pq mesh faults", [
        "--workload", "pq", "--scheduler", "pc-async", "--faults",
        "standard", "--requests", str(CLI_FAULT_REQUESTS), "--mesh-shards",
        str(PLACE_K)]))
    lines, _ = cli_serving(torch, dev, counters, runs)
    for name, stats, _l in lines:
        check(stats.get("placement") == pl.describe(),
              f"placement serve {name}: stats placement "
              f"{stats.get('placement')}")
    # decode places the scheduler's deadline PQ alone, as the reference
    with contextlib.redirect_stdout(io.StringIO()):
        dec = serve.main(["--workload", "decode", "--mesh-shards",
                          str(PLACE_K), "--sessions", "2", "--requests", "2",
                          "--tokens", "2", "--device", dev.type])
    check(dec.get("placement") == pl.describe()
          and dec["requests"] == 4 and dec["device_steps"] >= 1,
          f"placement serve decode: {dec}")
    refused = []
    for w in sorted(set(substrate.names()) - {"pq", "map", "graph"}):
        try:
            serve.main(["--workload", w, "--mesh-shards", str(PLACE_K),
                        "--device", dev.type])
        except ValueError:
            refused.append(w)
    check(refused == sorted(set(substrate.names()) - {"pq", "map", "graph"}),
          f"placement serve: refused {refused}")
    res["serve"] = {name: {"req_per_s": s["req_per_s"],
                           "requests": s["requests"]}
                    for name, s, _l in lines}
    out("placement serve: --mesh-shards 4 " + "; ".join(
        f"{name}: {s['requests']} requests, each applied once, "
        f"{s['req_per_s']} requests/s, {s['placement']}, launches {lc}"
        for name, s, lc in lines)
        + f"; decode: {dec['requests']} requests, deadline PQ "
        f"{dec['placement']}; refused (ValueError): {', '.join(refused)} "
        f"({time.perf_counter() - t0:.1f} s)")

    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["launches"] = {k: f.launches for k, f in counters.items()}
    c = res["collectives_ms"]
    out("placement times (no claim): " + "; ".join(
        f"{k} {v[0]:.6f} ms a call on the stream, {v[1]:.6f} ms of host"
        if v is not None else f"{k} not measured"
        for k, v in c.items()) + f"; phase launches "
        f"{_nonzero(res['launches'])}")
    if dist.is_initialized():
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t_phase
    return res


# phase 24: the mesh layer on one-rank meshes
SHARDED_TRAIN = (("rwkv6_3b", 2, 2048), ("recurrentgemma_2b", 2, 2048))
SHARDED_COMPRESS = "rwkv6_3b"   # the pod mesh's grad_compress run
SHARDED_STEPS = 3
SHARDED_SERVE = (8, 512, 8)     # Qwen2-0.5B: batch, prompt, decode steps
SHARDED_DRYRUN = ("qwen2_0_5b", "decode_32k")
# (d): the dry run's step-peak tracker against the card's allocator, one
# sharded train step each (the loss chunk's logits; the scan's scratch)
SHARDED_TRACKER = (("qwen2_0_5b", 2, 2048), ("rwkv6_3b", 2, 2048))
TRACKER_RTOL = 0.02
SHARDED_KERNELS = ("flash_attention", "rwkv6_scan", "rwkv6_scan_bwd",
                   "rglru_scan", "rglru_scan_bwd")


def one_rank_mesh(torch, dev, pods=False):
    """A data x model (or pod x data x model) mesh of one rank: a real
    group (NCCL on the card, loopback bootstrap; gloo on the CPU)."""
    import os

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_mesh_for_world

    if dev.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = make_mesh_for_world(1, device=dev)
    if pods:
        return DeviceMesh(dev.type, torch.arange(1).reshape(1, 1, 1),
                          mesh_dim_names=("pod", "data", "model"))
    return mesh


def _snapshot(torch, params, host):
    """A copy of every leaf (its local shard), on the device or (``host``:
    where the step's own transients leave no room beside three copies)
    on the host."""
    from repro_torch.optim.tree import leaves, local

    return [local(t).detach().to("cpu", copy=True) if host
            else local(t).detach().clone() for t in leaves(params)]


def _leaves_equal(torch, params, snap):
    """(how many leaves differ from ``snap``, the largest |difference|)."""
    from repro_torch.optim.tree import leaves, local

    bad, worst = 0, 0.0
    for t, s in zip(leaves(params), snap):
        g = local(t).detach()
        s = s.to(g.device)
        if not torch.equal(g, s):
            bad += 1
            worst = max(worst, float((g.float() - s.float()).abs().max()))
    return bad, worst


def _train_twin(torch, dev, seed, counters, cfg, batch, seq, steps, mesh,
                compress, snaps=None):
    """``steps`` train steps of fresh weights on the pipeline's batches:
    unsharded (``mesh=None``; ``compress`` adds the int8 round trip by
    hand) or through ``make_train_step(cfg, mesh)``.  Returns (the
    record, a device copy of the parameters after each step, or the
    comparison with ``snaps``)."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.compress import (compress_grads_int8,
                                            decompress_grads_int8)

    pipe = make_pipeline(cfg.vocab, seq, batch, seed=seed)
    params = transformer.model_init(seed, cfg, device=dev)
    if mesh is not None:
        params = sh.distribute_tree(params, sh.param_specs(cfg, mesh,
                                                           "train"), mesh)
    opt = adamw_init(params)
    if mesh is not None:
        step = st.make_train_step(cfg, mesh, lr=TRAIN_LR,
                                  grad_compress=compress)
    elif compress:
        def step(p, o, b):
            loss, g = st.loss_and_grads(p, cfg, b)
            q, s, _ = compress_grads_int8(g)
            p, o, gn = adamw_update(p, decompress_grads_int8(q, s), o,
                                    lr=TRAIN_LR)
            return p, o, {"loss": loss, "gnorm": gn}
    else:
        step = st.make_train_step(cfg, lr=TRAIN_LR)
    for f in counters.values():
        f.launches = 0
    rec = {"metrics": [], "ms": [], "diff": []}
    host = []
    for i in range(steps):
        b = device_batch(cfg, pipe.global_batch(i), i, seed, dev)
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        rec["metrics"].append(torch.stack([m["loss"].float(),
                                           m["gnorm"]]).tolist())
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if snaps is None:
            # the int8 round trip holds two more f32 copies of the
            # gradient: its twin's snapshots go to the host
            host.append(_snapshot(torch, params, host=compress))
        else:
            rec["diff"].append(_leaves_equal(torch, params, snaps[i]))
    _sync(torch, dev)
    rec["launches"] = {k: f.launches for k, f in counters.items()}
    rec["leaves"] = len(host[0]) if host else len(snaps[0])
    del params, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec, host


def _twins_line(name, u, d):
    bad = sum(b for b, _ in d["diff"])
    worst = max(w for _, w in d["diff"])
    return (f"{name}: loss/gnorm a step {d['metrics']} (unsharded "
            f"{u['metrics']}), {d['leaves']} leaves a step, {bad} differing"
            f" (worst {worst}); step ms {[round(x, 3) for x in d['ms']]} "
            f"sharded vs {[round(x, 3) for x in u['ms']]} unsharded; "
            f"launches {_nonzero(d['launches']) or 'none'} (unsharded "
            f"{_nonzero(u['launches']) or 'none'})")


def _same_launches(dev, name, u, d, expect):
    """Each kernel launched as often as in the unsharded twin; on the
    card, each kernel of ``expect`` at least once."""
    for k in SHARDED_KERNELS:
        check(d["launches"].get(k, 0) == u["launches"].get(k, 0),
              f"sharded {name}: {k} launched {d['launches'].get(k, 0)} "
              f"times, its unsharded twin {u['launches'].get(k, 0)}")
    for k in expect if dev.type == "cuda" else ():
        check(d["launches"][k] > 0, f"sharded {name}: kernel {k} was never "
                                    f"launched")


def sharded_train(torch, dev, seed, counters, runs, steps, reduced, out):
    """Part (a).  Returns the records and the launches of the sharded
    runs."""
    res = {"launches": dict.fromkeys(counters, 0), "models": {}}
    mesh = one_rank_mesh(torch, dev)
    pod = one_rank_mesh(torch, dev, pods=True)
    todo = [(arch, b, s, mesh, False) for arch, b, s in runs]
    if any(arch == SHARDED_COMPRESS for arch, _, _ in runs):
        b, s = next((b, s) for a, b, s in runs if a == SHARDED_COMPRESS)
        todo.append((SHARDED_COMPRESS, b, s, pod, True))
    for arch, batch, seq, m_, compress in todo:
        t0 = time.perf_counter()
        cfg = _model_cfg(arch, reduced)
        u, snaps = _train_twin(torch, dev, seed, counters, cfg, batch, seq,
                               steps, None, compress)
        d, _ = _train_twin(torch, dev, seed, counters, cfg, batch, seq,
                           steps, m_, compress, snaps)
        del snaps
        name = f"{arch}{' pod grad_compress' if compress else ''}"
        check(d["metrics"] == u["metrics"], f"sharded {name}: loss/gnorm "
              f"{d['metrics']} vs unsharded {u['metrics']}")
        check(all(b == 0 for b, _ in d["diff"]), f"sharded {name}: "
              f"parameters differ from the unsharded run's: {d['diff']}")
        _same_launches(dev, name, u, d, TRAIN_EXPECT.get(arch, ()))
        for k, n in d["launches"].items():
            res["launches"][k] += n
        key = arch + (" pod" if compress else "")
        res["models"][key] = {"unsharded": u, "sharded": d,
                              "mesh": str(tuple(m_.mesh_dim_names)),
                              "seconds": time.perf_counter() - t0}
        out(f"sharded train: {_twins_line(name, u, d)}; mesh "
            f"{tuple(m_.mesh_dim_names)} of one rank, {batch} x {seq}, "
            f"{cfg.n_layers} layers; bit-equal "
            f"({time.perf_counter() - t0:.1f} s)")
    return res


def sharded_tracker(torch, dev, seed, runs, reduced, out):
    """Part (d): ``launch/dryrun.py``'s ``Recorder`` on real tensors.  The
    first train step of fresh weights through ``make_train_step(cfg,
    mesh)`` on the one-rank mesh runs under it; its count of the step's
    temporaries at their peak (the bytes of the local tensors the step
    allocates, the arguments' storages excluded, sharding propagation's
    stand-ins skipped) is held to ``max_memory_allocated`` above the
    bytes allocated before the step.  Returns {arch: (tracked,
    allocator)}."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    mesh = one_rank_mesh(torch, dev)
    res = {}
    for arch, batch, seq in runs:
        t0 = time.perf_counter()
        cfg = _model_cfg(arch, reduced)
        params = sh.distribute_tree(transformer.model_init(seed, cfg,
                                                           device=dev),
                                    sh.param_specs(cfg, mesh, "train"), mesh)
        opt = adamw_init(params)
        step = st.make_train_step(cfg, mesh, lr=TRAIN_LR)
        b = device_batch(cfg, make_pipeline(cfg.vocab, seq, batch,
                                            seed=seed).global_batch(0), 0,
                         seed, dev)
        _sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        rec = dryrun.Recorder((params, opt, b))
        with rec:
            params, opt, m = step(params, opt, b)
            _sync(torch, dev)
        alloc = (torch.cuda.max_memory_allocated(dev) - base
                 if dev.type == "cuda" else rec.peak)
        res[arch] = (rec.peak, alloc)
        check(abs(rec.peak - alloc) <= TRACKER_RTOL * alloc,
              f"sharded tracker {arch}: tracked {rec.peak} bytes, the "
              f"allocator {alloc}")
        out(f"sharded tracker: {arch} ({cfg.n_layers} layers, {batch} x "
            f"{seq}), the first sharded train step on the one-rank mesh: "
            f"temporaries' peak tracked {rec.peak} bytes, "
            f"max_memory_allocated above the arguments {alloc} (tracked / "
            f"allocator {rec.peak / max(alloc, 1):.4f}, limit 1 +- "
            f"{TRACKER_RTOL}); {rec.flops:.4e} FLOP; loss "
            f"{float(m['loss']):.6f} ({time.perf_counter() - t0:.1f} s)")
        del params, opt, b, m, rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def sharded_serve(torch, dev, seed, counters, reduced, batch, prompt, new,
                  out):
    """Part (b): Qwen2-0.5B, TP layout, ``flash_attention`` in the
    scoring forward, the prefill and decode steps on the mesh."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer
    from repro_torch.optim.tree import leaves

    mesh = one_rank_mesh(torch, dev)
    cfg = _model_cfg(MODEL_ARCH, reduced).with_(
        attention_impl="pallas", pure_dp=False, remat=False,
        decode_cache_len=prompt + new)
    rng = np.random.default_rng([seed, 24])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))
                            .astype(np.int32)).to(dev)
    shd = sh.shard_ctx(cfg, mesh)
    runs = {}
    for label in ("unsharded", "sharded"):
        params = transformer.model_init(seed, cfg, device=dev)
        cache = transformer.init_cache(cfg, batch, prompt + new, device=dev)
        m_ = None
        if label == "sharded":
            m_ = mesh
            params = sh.distribute_tree(params, sh.param_specs(
                cfg, mesh, "serve"), mesh)
            cache = sh.distribute_tree(cache, sh.cache_specs(
                cfg, mesh, sh.cache_shapes(cfg, batch, prompt + new)), mesh)
        r = {"ms": {}}
        for f in counters.values():
            f.launches = 0
        with torch.no_grad():
            _sync(torch, dev)
            t0 = time.perf_counter()
            logits, _ = transformer.model_apply(
                params, cfg, {"tokens": toks},
                shd=shd if m_ is not None else None)
            _sync(torch, dev)
            r["ms"]["forward"] = (time.perf_counter() - t0) * 1e3
            r["forward"] = sh.gather_tree(logits).cpu()
            del logits
            pre = st.make_prefill_step(cfg, m_)
            dec = st.make_decode_step(cfg, m_)
            t0 = time.perf_counter()
            last, cache = pre(params, {"tokens": toks}, cache)
            _sync(torch, dev)
            r["ms"]["prefill"] = (time.perf_counter() - t0) * 1e3
            r["prefill"] = sh.gather_tree(last).cpu()
            nxt = torch.argmax(r["prefill"], -1).to(torch.int32).to(dev)
            toks_out, ms = [], []
            for i in range(new):
                t0 = time.perf_counter()
                nxt, cache = dec(params, cache, prompt + i,
                                 {"tokens": nxt[:, None]})
                nxt = sh.gather_tree(nxt)
                _sync(torch, dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                toks_out.append(nxt.cpu())
            r["ms"]["decode"] = float(np.median(ms))
            r["tokens"] = torch.stack(toks_out, 1)
            r["cache"] = [t.cpu() for t in leaves(sh.gather_tree(cache))]
        r["launches"] = {k: f.launches for k, f in counters.items()}
        runs[label] = r
        del params, cache
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    u, d = runs["unsharded"], runs["sharded"]
    for what in ("forward", "prefill", "tokens"):
        check(torch.equal(u[what], d[what]), f"sharded serve: the {what} "
              f"differs from the unsharded steps'")
    check(all(torch.equal(a, b) for a, b in zip(u["cache"], d["cache"])),
          "sharded serve: a cache tensor differs from the unsharded one")
    _same_launches(dev, "serve", u, d, ("flash_attention",))
    out(f"sharded serve: {MODEL_ARCH} (TP layout, attention_impl pallas): "
        f"scoring forward {batch} x {prompt}, prefill, {new} decode steps "
        f"on a mesh of one rank == unsharded bit for bit (logits, tokens, "
        f"{len(d['cache'])} cache tensors); ms sharded vs unsharded: "
        + ", ".join(f"{k} {d['ms'][k]:.3f} vs {u['ms'][k]:.3f}"
                    for k in ("forward", "prefill", "decode"))
        + f"; launches {_nonzero(d['launches']) or 'none'} (unsharded "
        f"{_nonzero(u['launches']) or 'none'})")
    return {"ms": {"sharded": d["ms"], "unsharded": u["ms"]},
            "launches": d["launches"]}


@contextlib.contextmanager
def sharded_dryrun(dev, cell=SHARDED_DRYRUN, out=print):
    """Part (c): one dry-run cell on 256 fake ranks, in a subprocess (the
    fake group stays out of this process) that runs on the host beside
    parts (a) and (b).  Yields a function that waits for it, checks its
    record, prints its line and returns the record; the subprocess is
    stopped when the block is left."""
    import os

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--out", tmp, "--device", dev.type],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)

    def result():
        so, se = proc.communicate(timeout=max(1.0, 300 - (
            time.perf_counter() - t0)))
        check(proc.returncode == 0, f"dry run {cell}: exit "
              f"{proc.returncode}\n{so[-1500:]}\n{se[-1500:]}")
        with open(os.path.join(tmp, f"{cell[0]}__{cell[1]}__16x16.json")) \
                as f:
            rec = json.load(f)
        check(rec["status"] == "ok" and rec["n_devices"] == 256,
              f"dry run {cell}: {rec.get('status')}")
        m, c = rec["memory"], rec["collectives"]
        kinds = ", ".join(f"{k} {v['count']}"
                          for k, v in c["by_kind"].items())
        out(f"sharded dry run: {cell[0]} {cell[1]} on 16 x 16 fake ranks "
            f"(device {dev.type}): ok; args {m['argument_size_in_bytes']} "
            f"bytes a device, {rec['flops']:.4e} FLOP a device, "
            f"{c['count']} collectives ({kinds}), traffic "
            f"{c['traffic_bytes_per_device']:.4e} bytes a device (the "
            f"cell {rec['run_s']} s; beside parts (a) and (b), waited for "
            f"{time.perf_counter() - t0:.1f} s after its start)")
        return rec

    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_phase(torch, dev, seed, counters, *, runs=SHARDED_TRAIN,
                  steps=SHARDED_STEPS, serve=SHARDED_SERVE,
                  tracker=SHARDED_TRACKER, dryrun=True, reduced=False,
                  out=print):
    """Phase 24 (the module docstring); the launches of parts (a) and (b)
    are the ``sharded`` path's."""
    t0 = time.perf_counter()
    with (sharded_dryrun(dev, out=out) if dryrun
          else contextlib.nullcontext()) as dry:
        tr = sharded_train(torch, dev, seed, counters, runs, steps, reduced,
                           out)
        tk = sharded_tracker(torch, dev, seed, tracker, reduced, out)
        sv = sharded_serve(torch, dev, seed, counters, reduced, *serve,
                           out=out)
        rec = {"train": tr["models"], "serve": sv, "tracker": tk,
               "launches": {k: tr["launches"].get(k, 0)
                            + sv["launches"].get(k, 0) for k in counters}}
        if dry:
            rec["dryrun"] = dry()
    rec["seconds"] = time.perf_counter() - t0
    out(f"sharded: {rec['seconds']:.1f} s, launches "
        f"{_nonzero(rec['launches'])}")
    return rec


def tree_graph(torch, dev, seed, n):
    """The graph phase's half-populated 10⁶-vertex tree as a stacked
    ``DeviceGraph``, its edge buffer written from numpy and its labels
    rebuilt once (the graph phase's set-up, which the placement phase's
    twins start from; ``--placement`` alone builds its own)."""
    from repro_torch.core.device_graph import DeviceGraph

    rng = np.random.default_rng([seed, 5])
    tu, tv = random_tree(rng, n)
    tree = list(zip(tu.tolist(), tv.tolist()))
    half = np.flatnonzero(np.random.default_rng([seed, 6]).random(n - 1)
                          < 0.5)
    g = DeviceGraph(n, edge_capacity=(n - 1) + 2 * C_MAX, c_max=C_MAX,
                    n_shards=4, device=dev)
    u = np.minimum(tu[half], tv[half])
    v = np.maximum(tu[half], tv[half])
    m = len(half)
    g.state.eu[:m] = torch.from_numpy(u).to(dev)
    g.state.ev[:m] = torch.from_numpy(v).to(dev)
    g.state.valid[:m] = True
    g.state.dirty_full.fill_(True)
    g._n_edges = m
    g._maybe_stale = True
    g.connected_batch([(0, 1)])               # the one full rebuild
    return g, tree


def run(dev_name="cuda", seed=0, n_keys=N_KEYS, threads=THREADS,
        ops=OPS_PER_THREAD, n_replay=REPLAY_BATCHES,
        n_cases=KERNEL_CASES,
        graph_vertices=GRAPH_VERTICES, graph_ops=GRAPH_OPS,
        graph_replay=GRAPH_REPLAY, uf_replay=UF_REPLAY, map_keys=MAP_KEYS,
        map_ops=MAP_OPS, map_replay=MAP_REPLAY, sketch_replay=SKETCH_REPLAY,
        attn_seq=MODEL_SEQ, model_reduced=False, model_batch=MODEL_BATCH,
        model_seq=MODEL_SEQ, serve_batch=SERVE_BATCH,
        serve_prompt=SERVE_PROMPT, serve_new=SERVE_NEW, gemma_seq=GEMMA_SEQ,
        rwkv_shapes=RWKV_SHAPES, rglru_shapes=RGLRU_SHAPES,
        rwkv_batch=RWKV_BATCH, rwkv_seq=RWKV_SEQ, rg_seq=RG_SEQ,
        struct_per=STRUCT_PER_SESSION, n_mega_lists=MEGA_LISTS, timing=True,
        place_map_batches=PLACE_MAP_BATCHES,
        place_graph_batches=PLACE_GRAPH_BATCHES,
        place_round_lists=PLACE_ROUND_LISTS,
        hubert_frames=HUBERT_FRAMES, train_runs=TRAIN_RUNS,
        train_steps=RUN_TRAIN_STEPS, bwd_rglru_shapes=RGLRU_BWD_SHAPES,
        bwd_rwkv_shapes=RWKV_BWD_SHAPES, grad_layers=GRAD_LAYERS,
        grad_seq=GRAD_SEQ, family_train_runs=FAMILY_TRAIN_RUNS,
        family_train_steps=RUN_FAMILY_TRAIN_STEPS, remat_seqs=RUN_REMAT_SEQS,
        remat_long=0, remat_bit=REMAT_BIT,
        spread_layers=REMAT_SPREAD_LAYERS, sharded_runs=SHARDED_TRAIN,
        sharded_steps=SHARDED_STEPS, sharded_serve=SHARDED_SERVE,
        sharded_dryrun=True, out=print):
    """Phases 2–24; returns the kernel records and each path's stats.
    (``dev_name="cpu"`` with small sizes, ``model_reduced=True`` and
    ``timing=False`` rehearses the control flow on the host, where the
    wrappers run their plain versions.)  The ``attn_remat`` sweep's long
    point (``REMAT_LONG``, ~204 s of host time a step on the card) runs
    under ``--train`` only, unless ``remat_long`` is given."""
    import torch

    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
    from repro_torch.core.pc_pq import (pc_priority_queue,
                                        pc_sharded_priority_queue)
    from repro_torch.kernels import (heap_insert, heap_kmin,
                                     heap_sift, label_prop, sorted_merge)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import (rglru_scan, rglru_scan_bwd,
                                                 rwkv6_scan, rwkv6_scan_bwd)

    dev = torch.device(dev_name)
    t_run = time.perf_counter()
    counters = {"heap_kmin": heap_kmin.k_smallest_sharded,
                "heap_sift": heap_sift.sift_wavefront_sharded,
                "heap_insert": heap_insert.phase4_sharded,
                "label_prop": label_prop.propagate,
                "sorted_merge": sorted_merge.merge_compact_sharded,
                "flash_attention": flash_attention,
                "rwkv6_scan": rwkv6_scan, "rglru_scan": rglru_scan,
                "rwkv6_scan_bwd": rwkv6_scan_bwd,
                "rglru_scan_bwd": rglru_scan_bwd}

    if dev.type == "cuda":
        build_line(out)

    cap1, cap4 = pq_capacities(n_keys, threads, ops, n_replay)
    checked, times = heap_phase(torch, dev, seed, cap1, cap4, n_cases,
                                timing, out)
    t0 = time.perf_counter()
    lp_chk, lp_timed, lp_steps = label_prop_phase(torch, dev, seed,
                                                  graph_vertices)
    checked.calls["label_prop"] = lp_chk.calls
    checked.max_abs_err["label_prop"] = lp_chk.max_abs_err
    if timing:
        times["label_prop"] = time_label_prop(torch, lp_timed)
    times.setdefault("label_prop", {})["fixpoint_steps"] = lp_steps
    out(label_prop_line(lp_chk, lp_steps, times["label_prop"] if timing
                        else {}, time.perf_counter() - t0))
    t0 = time.perf_counter()
    map_cap = shard_capacity(map_keys + threads * map_ops + 2, 4)
    sm_chk, sm_timed = sorted_merge_phase(torch, dev, seed, map_cap,
                                          map_keys // 4)
    checked.calls["sorted_merge"] = sm_chk.calls
    checked.max_abs_err["sorted_merge"] = sm_chk.max_abs_err
    if timing:
        times["sorted_merge"] = time_sorted_merge(torch, sm_timed)
    out(merge_line(sm_chk, times.get("sorted_merge", {}),
                   time.perf_counter() - t0, merge_sizes(map_cap)))

    rng = np.random.default_rng([seed, 0])
    init = rng.uniform(0, KEY_RANGE, n_keys).astype(np.float32)
    results = {}
    mega_pq = None
    for name, make, pass_fn in (
            ("pq-single",
             lambda: pc_priority_queue(bpq.BatchedPriorityQueue(
                 cap1, C_MAX, values=init, device=dev)),
             lambda st, ne, buf, ni, **kw: bpq.apply_batch_impl(
                 st, pq_row(dev, ne, buf, ni), c_max=C_MAX,
                 n_pull=max(ne - ni, 0), **kw)),
            ("pq-sharded",
             lambda: pc_sharded_priority_queue(cap4, C_MAX, n_shards=4,
                                               values=init, device=dev),
             lambda st, ne, buf, ni, **kw: spq._sharded_apply_batch(
                 st, pq_row(dev, ne, buf, ni), c_max=C_MAX, n_shards=4,
                 n_pull=ne, **kw))):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = make()
        s = pq_phase(torch, name, engine, init, counters, seed, threads,
                     ops, n_replay, pass_fn, bpq.PLAIN_PHASES)
        if dev.type == "cuda":
            s["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        results[name] = s
        if name == "pq-sharded":
            mega_pq = engine.pq
        out(f"{name}: {s['ops_per_s']:.1f} ops/s ({s['ops']} ops in "
            f"{s['seconds']:.3f} s, {threads} threads), passes "
            f"{s['passes']}, mean batch {s['mean_batch']:.3f}, eliminated "
            f"{s['eliminated']}, launches {s['launches']}, heap bytes "
            f"{s['heap_bytes']}, max_memory_allocated "
            f"{s.get('max_memory_allocated', 'n/a')}; conservation, heap "
            f"property and {s['replayed']}-batch kernel==plain replay ok "
            f"({time.perf_counter() - t0:.1f} s)")
        del engine

    t0 = time.perf_counter()
    s = megapass_phase(torch, dev, seed, mega_pq, init, cap4, counters,
                       threads, ops=ops, timing=timing,
                       n_lists=n_mega_lists, out=out)
    del mega_pq
    results["megapass"] = s
    out(f"megapass: {time.perf_counter() - t0:.1f} s")

    for name, phase, n_rep in (("graph", graph_phase, graph_replay),
                               ("unionfind", uf_phase, uf_replay)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = phase(torch, dev, seed, graph_vertices, threads, graph_ops,
                  n_rep, counters)
        if dev.type == "cuda":
            s["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        results[name] = s
        if name == "graph":
            graph_kept = s.pop("keep")
        extra = (f"{s['live_edges']} live edges at the end, the tree's "
                 f"half loaded from numpy in {s['prepopulate_s']:.3f} s; "
                 f"eliminated {s['eliminated']}"
                 f", full rebuilds {s['full_rebuilds']}, fast merges "
                 f"{s['fast_merges']}; replay rebuilds "
                 f"{s['replay_rebuilds']}, merges {s['replay_merges']}"
                 if name == "graph" else f"{s['unions']} unions")
        out(f"{name}: {s['ops_per_s']:.1f} ops/s ({s['ops']} ops in "
            f"{s['seconds']:.3f} s, {threads} threads, {READ_PCT}% reads), "
            f"passes {s['passes']}, mean batch {s['mean_batch']:.3f}, "
            f"{extra}, launches {s['launches']}, device bytes "
            f"{s['device_bytes']}, max_memory_allocated "
            f"{s.get('max_memory_allocated', 'n/a')}; checks and "
            f"{s['replayed']}-batch kernel==plain replay ok "
            f"({time.perf_counter() - t0:.1f} s)")

    for name, phase, n_rep in (("map", map_phase, map_replay),
                               ("sketch", sketch_phase, sketch_replay)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = phase(torch, dev, seed, map_keys, threads, map_ops, n_rep,
                  counters)
        if dev.type == "cuda":
            s["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        results[name] = s
        if name == "map":
            w, mp = s["range_sum"], s["megapass"]
            extra = (f"{s['inserted']} inserts and {s['deleted']} deletes "
                     f"took effect, final size {s['final_size']}; range_sum"
                     f" worst error {w['abs']} (at a sum of {w['at']}) "
                     f"over {w['n']} answers: {w['over_ref']} outside the "
                     f"reference's tolerance (worst error/tolerance "
                     f"{w['ratio']:.4f}), worst error {w['eps_p']:.2f} "
                     f"eps_f32 * prefix (limit {RANGE_SUM_EPS}), "
                     f"{w['exact_probes']} narrow low-prefix probes within "
                     f"the reference's tolerance (worst error "
                     f"{w['exact_worst']:.3g}); megapass {mp['rounds']} "
                     f"rounds in {mp['dispatches']} dispatches == "
                     f"alternating")
        else:
            extra = (f"{s['adds']} adds, {s['created']} created, final "
                     f"total {s['total']}")
        out(f"{name}: {s['ops_per_s']:.1f} ops/s ({s['ops']} ops in "
            f"{s['seconds']:.3f} s, {threads} threads, {READ_PCT}% reads), "
            f"passes {s['passes']}, mean batch {s['mean_batch']:.3f}, "
            f"host ms per pass {s['host_ms_per_pass']:.3f}, {extra}; "
            f"launches {s['launches']}, capacity {s['capacity']} a shard, "
            f"set-up {s['setup_s']:.1f} s, device bytes "
            f"{s['device_bytes']}, max_memory_allocated "
            f"{s.get('max_memory_allocated', 'n/a')}; checks and "
            f"{s['replayed']}-batch kernel==plain replay ok in "
            f"{s['replay_s']:.1f} s ({time.perf_counter() - t0:.1f} s)")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    results["placement"] = placement_phase(
        torch, dev, seed, counters, init, cap4, graph_kept, threads=threads,
        ops=ops, n_replay=n_replay, map_keys=map_keys,
        map_batches=place_map_batches, graph_batches=place_graph_batches,
        round_lists=place_round_lists, out=out)
    del graph_kept
    out(f"placement: {results['placement']['seconds']:.1f} s")
    t0 = time.perf_counter()
    fa = attention_phase(torch, dev, seed, attn_seq, gemma_seq, timing,
                         hubert_frames)
    checked.calls["flash_attention"] = fa["checked"]
    checked.max_abs_err["flash_attention"] = fa["max_abs_err"]
    if timing:
        times["flash_attention"] = fa
    out(f"kernels: flash_attention == plain on {fa['checked']} launches "
        f"({len(ATTN_CASES) + 5} cases x f32, bf16; max_abs_err "
        f"{fa['max_abs_err_by_dtype']['float32']} f32, "
        f"{fa['max_abs_err_by_dtype']['bfloat16']} bf16; tolerance atol = "
        f"rtol = 2e-5 f32, 2e-2 bf16; bf16 rows' relative norm error "
        f"{fa['max_row_err_bf16']} (limit {ATTN_ROW_TOL}); "
        f"{time.perf_counter() - t0:.1f} s); "
        + ("timing not measured" if not timing else
           f"ms {fa['ms']:.6f} at {fa['shape']} bf16 causal, plain_ms "
           f"{fa['plain_ms']:.6f}, bound_ms {fa['bound_ms']:.6f} "
           f"({fa['bound_by']}: {fa['flop']:.4e} FLOP of the unmasked pairs "
           f"/ 989 TFLOP/s bf16 vs {fa['bytes']} bytes / 3.35 TB/s), "
           f"library_ms {fa['library_ms']:.6f} (SDPA is_causal, "
           f"enable_gqa; |SDPA - kernel| {fa['library_err']}); " + "; ".join(
               f"{label} {fa[p + 'shape']}: ms {fa[p + 'ms']:.6f}, plain_ms "
               f"{fa[p + 'plain_ms']:.6f}, bound_ms "
               f"{fa[p + 'bound_ms']:.6f} ({fa[p + 'bound_by']}: "
               f"{fa[p + 'flop']:.4e} FLOP)" + (
                   "" if p + "library_ms" not in fa else
                   f", library_ms {fa[p + 'library_ms']:.6f} (SDPA; "
                   f"|SDPA - kernel| {fa[p + 'library_err']})")
               for label, p in (("gemma2", "gemma_"),
                                ("recurrentgemma", "rg_"),
                                ("hubert", "hubert_"),
                                ("llama4", "llama4_")))))

    serving = dict(serve_batch=serve_batch, prompt=serve_prompt,
                   new=serve_new)
    lm = model_runner(torch, dev, seed, counters, results,
                      reduced=model_reduced, serve_batch=serve_batch,
                      serve_prompt=serve_prompt, serve_new=serve_new,
                      out=out)

    lm("model", model_phase, batch=model_batch, seq=model_seq, keep=True,
       **serving)
    cfg_m, params_m = results["model"].pop("keep")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    s = serve_phase(torch, dev, seed, counters, cfg_m, params_m, init,
                    batch=serve_batch, prompt=serve_prompt, new=serve_new,
                    struct_per=struct_per, out=out)
    if dev.type == "cuda":
        s["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    results["serve"] = s
    del params_m
    lm("gemma2", gemma2_phase, seq=gemma_seq)

    t0 = time.perf_counter()
    ls = linear_scan_phase(torch, dev, seed, rwkv_shapes, rglru_shapes,
                           timing)
    for name, r in ls.items():
        checked.calls[name] = r["checked"]
        checked.max_abs_err[name] = r["max_abs_err"]
        if timing:
            times[name] = r
    out(scan_line(ls, time.perf_counter() - t0, timing))

    lm("rwkv6", model_phase, batch=rwkv_batch, seq=rwkv_seq, name="rwkv6",
       arch=RWKV_ARCH, tag=16, **serving)
    lm("recurrentgemma", model_phase, batch=1, seq=rg_seq,
       name="recurrentgemma", arch=RG_ARCH, n_layers=RG_LAYERS, tag=17,
       prepare=slow_decay, **serving)
    family_phases(lm, model_seq, hubert_frames, serving)
    tr = train_phase(torch, dev, seed, counters, runs=train_runs,
                     steps=train_steps, rglru_shapes=bwd_rglru_shapes,
                     rwkv_shapes=bwd_rwkv_shapes, grad_layers=grad_layers,
                     grad_seq=grad_seq, family_runs=family_train_runs,
                     family_steps=family_train_steps, remat_seqs=remat_seqs,
                     remat_long=remat_long, remat_bit=remat_bit,
                     spread_layers=spread_layers, reduced=model_reduced,
                     profile=False, timing=timing, out=out)
    results["train"] = tr["train"]
    for name, r in tr["bwd"].items():
        checked.calls[name] = r["checked"]
        checked.max_abs_err[name] = r["max_abs_err"]
        if timing:
            times[name] = r
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    results["sharded"] = sharded_phase(
        torch, dev, seed, counters, runs=sharded_runs, steps=sharded_steps,
        serve=sharded_serve, dryrun=sharded_dryrun, reduced=model_reduced,
        out=out)
    out(f"run: phases 2-24 in {time.perf_counter() - t_run:.1f} s")

    paths = {"heap_kmin": ("pq-single", "pq-sharded", "megapass", "serve",
                           "placement"),
             "heap_sift": ("pq-single", "pq-sharded", "megapass", "serve",
                           "placement"),
             "heap_insert": ("pq-single", "pq-sharded", "megapass",
                             "serve", "placement"),
             "label_prop": ("graph", "unionfind", "serve", "placement"),
             "sorted_merge": ("map", "sketch", "serve", "placement"),
             "flash_attention": ("model", "gemma2", "recurrentgemma",
                                 "llama4", "vision", "hubert", "sharded"),
             "rwkv6_scan": ("rwkv6", "train", "sharded"),
             "rglru_scan": ("recurrentgemma", "train", "sharded"),
             "rwkv6_scan_bwd": ("train", "sharded"),
             "rglru_scan_bwd": ("train", "sharded")}
    kernels = []
    for name in counters:
        t = times.get(name, {})
        rec = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the driven paths together, and each path's own count
            "launches": sum(results[p]["launches"][name]
                            for p in paths[name]),
            "launches_by_path": {p: results[p]["launches"][name]
                                 for p in paths[name]},
            "max_abs_err": checked.max_abs_err[name],
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
        }
        if name == "label_prop":
            rec.update({k: t.get(k) for k in (
                "step_fixpoint_ms", "chain_ms", "gated_off_ms", "step_ms",
                "step_plain_ms", "step_bound_ms", "merge_ms",
                "merge_plain_ms",
                "merge_gated_off_ms", "merge_bound_ms", "uf_merge_ms",
                "uf_bound_ms", "fixpoint_steps")})
        if name == "sorted_merge":
            rec.update({k: t.get(k) for k in ("none_ms", "empty_ms")})
        if name == "flash_attention":
            rec.update({k: t.get(k) for k in (
                "shape", "gemma_shape", "gemma_ms", "gemma_plain_ms",
                "gemma_bound_ms", "rg_shape", "rg_ms", "rg_plain_ms",
                "rg_bound_ms") + tuple(
                    p + k for p in ("hubert_", "llama4_") for k in (
                        "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms"))})
        if name == "rwkv6_scan":
            rec.update({k: t.get(k) for k in (
                "step_ms", "by_batch", "prefill_shape", "prefill_ms",
                "prefill_step_ms", "prefill_bound_ms", "decode_shape",
                "decode_ms", "decode_bound_ms")})
        if name == "rglru_scan":
            rec.update({k: t.get(k) for k in (
                "prefill_shape", "prefill_ms", "prefill_bound_ms")})
        if name in ("rwkv6_scan_bwd", "rglru_scan_bwd"):
            rec.update({k: t.get(k) for k in (
                "shape", "peak_bytes", "serve_shape", "serve_ms",
                "serve_plain_ms", "serve_bound_ms", "scratch_bytes")})
        if name in ("rwkv6_scan", "rglru_scan"):
            p = paths[name][0]
            rec["shape"] = t.get("shape")
            rec["per_forward"] = results[p]["per_forward"][name]
            rec["serving_call"] = results[p]["serve_launches"][name]
        kernels.append(rec)
    return kernels, results


def build_line(out=print):
    """Phase 2: build the kernels; print the time and ptxas's report."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    smem = _build.library().rglru_scan_smem_bytes()
    bwd_smem = (_build.library().rwkv6_scan_bwd_smem_bytes(),
                _build.library().rglru_scan_bwd_smem_bytes())
    log = (lib.parent / "build.log").read_text()
    cufilt = str(Path(_build.nvcc_path()).parent / "cu++filt")
    out(f"build: {time.perf_counter() - t0:.1f} s, {lib}; ptxas "
        "(registers, spill stores / loads in bytes): " + "; ".join(
            f"{src} {n} {r} regs, spills {st} / {ld}"
            for src, n, r, st, ld in ptxas_report(log, cufilt))
        + f"; rglru_scan's ring and output stage: {smem} bytes of dynamic "
        f"shared memory a CTA; rwkv6_scan_bwd's ring, chunk states and dv "
        f"tile {bwd_smem[0]}; rglru_scan_bwd's rings {bwd_smem[1]}")


def heap_only(torch, seed):
    """``--heap``: phases 2 and 3 alone, for work on the heap kernels."""
    build_line()
    cap1, cap4 = pq_capacities(N_KEYS, THREADS, OPS_PER_THREAD,
                               REPLAY_BATCHES)
    heap_phase(torch, torch.device("cuda"), seed, cap1, cap4, KERNEL_CASES,
               True)


def merge_only(torch, seed):
    """``--merge``: phases 2 and 9 alone, for work on ``sorted_merge``."""
    build_line()
    t0 = time.perf_counter()
    map_cap = shard_capacity(MAP_KEYS + THREADS * MAP_OPS + 2, 4)
    chk, timed = sorted_merge_phase(torch, torch.device("cuda"), seed,
                                    map_cap, MAP_KEYS // 4)
    print(merge_line(chk, time_sorted_merge(torch, timed),
                     time.perf_counter() - t0, merge_sizes(map_cap)))


def label_prop_only(torch, seed):
    """``--label-prop``: phases 2 and 6 alone, for work on ``label_prop``."""
    build_line()
    t0 = time.perf_counter()
    chk, timed, steps = label_prop_phase(torch, torch.device("cuda"), seed,
                                         GRAPH_VERTICES)
    print(label_prop_line(chk, steps, time_label_prop(torch, timed),
                          time.perf_counter() - t0))


def scan_only(torch, seed):
    """``--scan``: phases 2, 16 and 23 (a) alone, for work on the scan
    kernels and their backwards."""
    build_line()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ls = linear_scan_phase(torch, dev, seed, RWKV_SHAPES, RGLRU_SHAPES, True)
    print(scan_line(ls, time.perf_counter() - t0, True))
    t0 = time.perf_counter()
    bwd = scan_bwd_phase(torch, dev, seed, RGLRU_BWD_SHAPES,
                         RWKV_BWD_SHAPES, True)
    print(bwd_line(bwd, time.perf_counter() - t0))


def train_only(torch, seed):
    """``--train``: phase 2 and phase 23 alone, for work on the training
    path and the backward kernels."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import (rglru_scan, rglru_scan_bwd,
                                                 rwkv6_scan, rwkv6_scan_bwd)

    build_line()
    counters = {"flash_attention": flash_attention,
                "rwkv6_scan": rwkv6_scan, "rglru_scan": rglru_scan,
                "rwkv6_scan_bwd": rwkv6_scan_bwd,
                "rglru_scan_bwd": rglru_scan_bwd}
    train_phase(torch, torch.device("cuda"), seed, counters)


def families_only(torch, seed):
    """``--families``: phase 2 and phases 19-22 alone (llama4, deepseek,
    the VLM, HuBERT), for work on the model stack."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import rglru_scan, rwkv6_scan

    build_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"flash_attention": flash_attention,
                "rwkv6_scan": rwkv6_scan, "rglru_scan": rglru_scan}
    t0 = time.perf_counter()
    lm = model_runner(torch, dev, seed, counters, {}, reduced=False,
                      serve_batch=SERVE_BATCH, serve_prompt=SERVE_PROMPT,
                      serve_new=SERVE_NEW)
    family_phases(lm, MODEL_SEQ, HUBERT_FRAMES,
                  dict(serve_batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                       new=SERVE_NEW))
    print(f"families: {time.perf_counter() - t0:.1f} s")


def serve_only(torch, seed):
    """``--serve``: phases 2 and 14 alone, on fresh random Qwen2-0.5B
    weights, for work on the serving layer."""
    from repro_torch.kernels import (heap_insert, heap_kmin, heap_sift,
                                     label_prop, sorted_merge)
    from repro_torch.models import transformer

    build_line()
    dev = torch.device("cuda")
    cfg = _model_cfg(MODEL_ARCH, False)
    params = transformer.model_init(seed, cfg, device=dev)
    init = np.random.default_rng([seed, 0]).uniform(
        0, KEY_RANGE, N_KEYS).astype(np.float32)
    counters = {"heap_kmin": heap_kmin.k_smallest_sharded,
                "heap_sift": heap_sift.sift_wavefront_sharded,
                "heap_insert": heap_insert.phase4_sharded,
                "label_prop": label_prop.propagate,
                "sorted_merge": sorted_merge.merge_compact_sharded}
    serve_phase(torch, dev, seed, counters, cfg, params, init)


def placement_only(torch, seed):
    """``--placement``: phase 2 and the placement phase alone, for work on
    the placement layer; the graph twins start from :func:`tree_graph`."""
    from repro_torch.kernels import (heap_insert, heap_kmin, heap_sift,
                                     label_prop, sorted_merge)

    build_line()
    dev = torch.device("cuda")
    _, cap4 = pq_capacities(N_KEYS, THREADS, OPS_PER_THREAD, REPLAY_BATCHES)
    init = np.random.default_rng([seed, 0]).uniform(
        0, KEY_RANGE, N_KEYS).astype(np.float32)
    counters = {"heap_kmin": heap_kmin.k_smallest_sharded,
                "heap_sift": heap_sift.sift_wavefront_sharded,
                "heap_insert": heap_insert.phase4_sharded,
                "label_prop": label_prop.propagate,
                "sorted_merge": sorted_merge.merge_compact_sharded}
    t0 = time.perf_counter()
    graph = tree_graph(torch, dev, seed, GRAPH_VERTICES)
    print(f"placement set-up: the graph's tree written from numpy and "
          f"rebuilt once in {time.perf_counter() - t0:.1f} s")
    s = placement_phase(torch, dev, seed, counters, init, cap4, graph)
    print(f"placement: {s['seconds']:.1f} s")


def megapass_only(torch, seed):
    """``--megapass``: phase 2 and the megapass phase alone, on a fresh
    K = 4 queue of the pq phases' 4,000,000 seeded keys."""
    from repro_torch.core.sharded_pq import ShardedBatchedPQ
    from repro_torch.kernels import heap_insert, heap_kmin, heap_sift

    build_line()
    dev = torch.device("cuda")
    _, cap4 = pq_capacities(N_KEYS, THREADS, OPS_PER_THREAD, REPLAY_BATCHES)
    init = np.random.default_rng([seed, 0]).uniform(
        0, KEY_RANGE, N_KEYS).astype(np.float32)
    counters = {"heap_kmin": heap_kmin.k_smallest_sharded,
                "heap_sift": heap_sift.sift_wavefront_sharded,
                "heap_insert": heap_insert.phase4_sharded}
    t0 = time.perf_counter()
    pq = ShardedBatchedPQ(cap4, C_MAX, n_shards=4, values=init, device=dev)
    megapass_phase(torch, dev, seed, pq, init, cap4, counters, THREADS)
    print(f"megapass: {time.perf_counter() - t0:.1f} s")


def sharded_only(torch, seed):
    """``--sharded``: phase 2 and phase 24 alone, for work on the mesh
    layer."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import (rglru_scan, rglru_scan_bwd,
                                                 rwkv6_scan, rwkv6_scan_bwd)

    build_line()
    counters = {"flash_attention": flash_attention,
                "rwkv6_scan": rwkv6_scan, "rglru_scan": rglru_scan,
                "rwkv6_scan_bwd": rwkv6_scan_bwd,
                "rglru_scan_bwd": rglru_scan_bwd}
    sharded_phase(torch, torch.device("cuda"), seed, counters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="only the pass-time breakdown (profile_passes), "
                         "not the checks")
    ap.add_argument("--scan", action="store_true",
                    help="only the build and the linear_scan kernel checks "
                         "and timings, the backwards' too (phases 2, 16 "
                         "and 23 (a))")
    ap.add_argument("--heap", action="store_true",
                    help="only the build and the heap kernel checks and "
                         "timings (phases 2 and 3)")
    ap.add_argument("--merge", action="store_true",
                    help="only the build and the sorted_merge kernel checks "
                         "and timings (phases 2 and 9)")
    ap.add_argument("--serve", action="store_true",
                    help="only the build and the serving phase, on fresh "
                         "random weights (phases 2 and 14)")
    ap.add_argument("--megapass", action="store_true",
                    help="only the build and the megapass phase (phase 2 "
                         "and the phase after 5)")
    ap.add_argument("--families", action="store_true",
                    help="only the build and the llama4, deepseek, vision "
                         "and hubert phases (phases 2 and 19-22)")
    ap.add_argument("--train", action="store_true",
                    help="only the build and the training phase (phases 2 "
                         "and 23)")
    ap.add_argument("--placement", action="store_true",
                    help="only the build and the placement phase (phase 2 "
                         "and the phase after 11)")
    ap.add_argument("--sharded", action="store_true",
                    help="only the build and the mesh layer's phase on "
                         "one-rank meshes (phases 2 and 24)")
    ap.add_argument("--label-prop", action="store_true",
                    help="only the build and the label_prop kernel checks "
                         "and timings (phases 2 and 6)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs the "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    if args.profile:
        profile_passes(seed=args.seed)
        return 0
    if args.scan:
        scan_only(torch, args.seed)
        return 0
    if args.merge:
        merge_only(torch, args.seed)
        return 0
    if args.heap:
        heap_only(torch, args.seed)
        return 0
    if args.label_prop:
        label_prop_only(torch, args.seed)
        return 0
    if args.serve:
        serve_only(torch, args.seed)
        return 0
    if args.megapass:
        megapass_only(torch, args.seed)
        return 0
    if args.placement:
        placement_only(torch, args.seed)
        return 0
    if args.families:
        families_only(torch, args.seed)
        return 0
    if args.train:
        train_only(torch, args.seed)
        return 0
    if args.sharded:
        sharded_only(torch, args.seed)
        return 0
    kernels, _ = run("cuda", seed=args.seed)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
