#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the exact local count (Algorithm
1), triangle finding, per-vertex credit, the stream route (exact batch
deltas), LM serving (smollm-135m prefill and KV-cache decode), GatedGCN
training, the batch route with its triangle server, the approx route
with robust serving, distributed Algorithm 2, the trace-driven
autotuner, the static auditor, the training of GAT, SchNet and DimeNet,
LM training (smollm-135m), the MoE LM qwen2-moe-a2.7b (served and
trained, and on its explicit expert-parallel path), the recsys BST
(trained, served and scored over 10^6 candidates), the int8 gradient
psum and the dry run end to end on one NVIDIA H100, through the
hand-written Hopper kernels K1 to K5 and K5's backward.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero; nothing is caught and skipped):

  1. setup   — versions, toolchain, the card's name and power limit, and
               the build of every CUDA source with nvcc (timed);
  2. kernel  — K1, K2 and K3 against their plain PyTorch versions on the
               same CUDA tensors: every row of every bucket of RMAT
               scale 16 (each also with every live row forced onto the
               bitmap and onto the row walk, K3 also onto its tiles;
               K3 also against K1's c1 + c2), and a seeded sample of
               4,096 rows from each bucket at full size;
  3. small   — ``TriangleEngine(device="cuda").count`` on karate and RMAT
               scales 10, 12 and 16, each count asserted; the per-vertex
               credit, the found list and two stream sessions (with and
               without credit) at scale 12 against the port's CPU path;
  4. full    — RMAT scale 20 (Graph500, edge factor 16, seed 0), the
               largest scale at which the int32 c1/c2 contract holds.
               Three main paths, each a warm-up run with the launch
               counters set to 0 just before and read just after, then
               timed runs (per-stage seconds, peak device memory):
               the count (K1), the per-vertex count (K2; credit summing
               to 3T), and ``find`` with a buffer of every triangle (K2;
               unique, closed triangles whose corners are the per-vertex
               credit); one profiled run of each for the device's busy
               share.  Per
               bucket: each kernel's milliseconds at the main path's
               launch shapes (K1 one launch per bucket, on the device
               with the host's enqueue hidden, and one call profiled by
               kernel name; K2 one per chunk of the cell budget, its
               device time from one profiled call each and its
               host-paced time from CUDA events, since it reads its
               output's size back; each wrapper call whole, its layout
               included; K3 one per bucket of the same plan run
               level-free, equal to K1's c1 + c2 row for row, on the
               device and host-paced, by the rule and by each path, one
               call profiled by kernel name) beside its
               bound (bytes once, one test per candidate cell and, for
               K1, one level compare per hit) and the binary search's
               bound, and the plain version on the same rows, timed and
               compared; K1 and K2 also timed with every live row on the
               bitmap and on the row walk, each equal to the main path's
               bits and a second launch too; the path each bucket takes,
               its items, live rows and distinct targets logged.
  5. stream  — stream sessions on the same graph (``stream_staleness``
               1e9, so the timed path is pure delta maintenance): the
               session's opening count, one warm-up and 8 timed applies
               of 4,096 mixed updates (K3); K3 at the probes' own
               launch shapes (the launches of 8 further applies,
               recorded, each timed on the device and host-paced by the
               rule and by each path, beside its bound, held against its
               plain version on every row and its path logged); a
               session with a 65,536-update buffer (a warm-up and 3
               timed applies of 65,536, K3 alone; its launches of one
               further apply timed and held the same way; a fresh
               count); 4 timed applies with
               per-vertex credit in a second session (K2), K2 at its
               probes' shapes (the launches of 2 further applies, each
               timed by the rule and by each forced path, the same bits),
               one apply of 1 % of the edges, and a forced refresh (K1); each checked
               against a fresh count, with updates per second, stage
               split, host syncs, K3's device time and peak memory.
  6. lm      — K5 against its plain version over the reference's sweep
               and the models' shapes (smollm-135m prefill and decode,
               gemma3-1b's D 256 with a window of 512, bf16, the smoke
               widths; each case twice, equal bit for bit, its decode
               splits logged); then smollm-135m at full width (random
               weights, seed 0) serves two requests — the server's default
               (batch 4, prompt 32, 16 generated) and a long one (batch
               8, prompt 1,920, 128 generated, 2,048 positions): a
               warm-up and 3 timed serves each (prefill ms, decode ms per
               step, tokens per second, peak memory; the first with the
               launch counters set to 0 just before and read just
               after: K5 alone, 30 launches per step), one profiled
               (busy share), and one with every K5 call recorded and
               timed on the device (the host's enqueue hidden) and
               host-paced, beside its bounds (float32 FMA, 3xTF32), its
               plain version (compared; launched twice) and SDPA.  Last, the default
               request on the CPU through the plain path with the same
               weights and ids, and the card fed the CPU's ids (teacher
               forcing): logits within SERVE_TOL and the greedy ids
               equal wherever the CPU's top-2 margin exceeds it.
  7. gnn     — K4 against its plain version summed in float64, each
               case launched twice and equal bit for bit and to its order
               emulated in plain PyTorch (the reference's sweep, the zipf
               hub, an RMAT hub of 2,779 edges, one segment over 63
               chunks, bf16, negative and sentinel ids, F = 70); then
               GatedGCN at full width and depth (16 layers, d_hidden 70,
               1,433 features, 16 classes, float32, AdamW, random weights
               from seed 0) trained through ``launch/train.py``'s pieces
               at two sizes: run A (Cora's 2,708 nodes and 10,556 edges;
               first the first step's loss and gradients against the
               CPU's plain path) and run B (169,984 nodes, 84,480 edges:
               the registry's minibatch_lg block).  Each: a warm-up step,
               one step with the launch counters set to 0 just before
               and read just after (K4 alone, 2 x 16 launches), timed
               steps (20 and 10; ms, steps/s, the loss falling, peak
               memory), one profiled (busy share, top kernels), and one
               with every K4 call recorded and timed beside its bound,
               its plain version (compared) and ``index_add_``, its
               chunks per call logged.
  8. serve_tc — the batch route and the triangle server.  (a) One
               batch of 8 lanes of RMAT scale 16 (seeds 0-7, about the
               size of SNAP's ego-Twitter) through ``count_batch`` on its
               bounded plan (packed from the edge lists), on its exact
               plan (packed once, no meta) and with per-vertex credit
               (K2): each a main path (one K1 launch per bucket over all
               lanes; K2 alone for the credit), then 3 timed runs (wall,
               stages pack / bfs and its sweeps / compact / plan /
               probe, peak memory) and one profiled (busy share); every
               lane equal to its own local count on the card (credit
               summing to 3T); every K1 and K2 launch of the lane view
               recorded, timed on the device and host-paced beside its
               bound, and held against its plain version on every row.
               (b) ``measure_serve`` over the reference's mix of 96
               requests and a mix of 64 ``rmat(s, 16)`` with s drawn from
               12-16, at batch sizes 1, 8 and 16 against the
               budget-padded sequential loop; every request id agreeing.
  9. robust  — the approx route and robust serving.  (a) ``count(route=
               "approx")`` at full size (8,192 wedge samples, seed 0, host
               numpy, no launch): seconds, estimate and stderr, within 4
               stderr of the exact count; on one rmat16 request, the
               approx lane's seconds beside the latency of the same
               request served exactly alone (median of 3 each).  (b) The
               wedge baseline on the card at rmat12, equal to the local
               count.  (c) Phase 8's two mixes as open-loop burst traces
               through ``launch/robust.py:run_chaos`` (synth_96: bursts
               of 12, 0.05 s gaps, deadline 0.05 s; rmat12_16_64: bursts
               of 16, 0.5 s gaps, deadline 1.0 s), each without and with
               a deadline, 3 replays each after one unmeasured pass
               (the two alternating): graphs/s, p50/p99 and their spread,
               deadline and size flushes, each cell's flush-cost EWMA; K1
               alone, no approx answer, no failed batch, every answer
               equal to the sequential loop's on its id.  (d) synth_96
               under the reference smoke's batch fault classes
               (malformed, oversized, stalls, failed dispatches) with 16
               admission tokens: the audit ``ok``, the failed batches
               equal to the injected faults and to the ordinal rule, the
               exact answers equal to the loop's, every approx answer
               equal to the CPU's ``count_approx`` at ``seed=id``.
 10. distributed — Algorithm 2 over ``LocalShards(8, "cuda")`` (8
               logical shards stacked on the card).  (a) karate and
               rmat10 in both hedge modes, with and without per-vertex
               credit: triangles, ``per_device``, ``recv_counts``,
               flags and comm bytes equal to the port's CPU path and to
               the reference's pinned values, credit summing to 3T,
               ``comm_report`` measured == tally == modeled; rmat16 at
               p = 1, 2, 4, 8 equal to the local count (every comm
               phase 0 at p = 1).  (b) The full-size graph at p = 8 in
               ``allgather`` and ``ring``: each a main path (K3 alone),
               3 timed runs (stages shard / bfs / transpose / hedge /
               reduce), one profiled (busy share), peak memory; the
               count, the horizontal edges and no overflow exact, the
               three comm figures equal, the hedge bytes equal across
               modes; one per-vertex run (the router's mode, K2 alone)
               with credit summing to 3T, then every K2 launch of one
               more such run timed beside its bound, its offsets held
               against the plain version on every row and its mask on
               a seeded sample of 4,096 rows.  (c) K3 at the hedge
               rounds' own launch shapes: every launch of one more run
               a mode, timed on the device and host-paced beside its
               bound, its path logged, and held against its plain
               version on a seeded sample of 4,096 rows (every row of a
               smaller launch).  A disagreement in (b) or (c) ends the
               run.  (d) A server over ``BudgetGrid(max_nodes=256,
               max_slots=2048)``: an over-budget ``rmat(9, 8)`` answered
               on the route, equal to the local count, also after a
               stalled first attempt times out (retried in ring mode).
               (e) ``parallel_wedge_triangle_count`` at rmat12, equal to
               T, its wire bytes and paper bits beside cover-edge's.
 11. tune    — the autotuner.  (a) ``record_serve_trace(96, seed=0,
               heavy_every=4)`` on the card (the reference's tuning
               trace, written and read back), swept over the card's
               ``default_space`` by successive halving at 3 timed
               replays a config: each config bit-identical to the
               baseline, the baseline equal to the sequential loop on
               every id; graphs/s, p50 / p99, each rung's ranking.  (b)
               Phase 8's rmat12_16_64 mix, recorded in memory at batch
               8, swept the same at 1 timed replay over 6 of the 13
               configs (``TUNE_REAL_SPACE``).  (c) For each, the
               winner's profile (its ``objective`` naming the card and
               its power limit) saved, loaded and served by
               ``prewarm_replay`` on a fresh engine: ``plan_hit`` 1.0,
               ``jit_compiles`` 0, the sweep's answers; and the winner
               against the default in turns (default, winner, winner,
               default; 3 rounds for (a), 1 for (b)).  (d) Two fresh
               processes serve (b)'s first 3 requests one at a time,
               twice: one cold, one prewarmed from (b)'s profile (its
               ``jit_compiles`` 0 throughout); the latencies and the
               prewarm's seconds are logged.  (e) Every K1 launch of one
               more replay of (b)'s winner, timed on the device and
               host-paced beside its bound and path, held against its
               plain version on a seeded sample of 4,096 rows (every row
               of a smaller launch) and launched twice.
 12. audit   — the static auditor (``repro_torch.analysis``).  (a)
               ``run_audit()`` on the card's host (its routes run on the
               CPU by design), diffed against
               ``results/AUDIT_torch_baseline.json``: any new or vanished
               finding ends the run.  (b) A ``TriangleEngine`` on the
               card with the reference's ``results/tuned/serve_mix.json``
               (read only) and ``serve(batch_size=8, prewarm=True)`` as a
               main path: the plan cache holds exactly the plan keys of
               ``compile_space(batch_size=8)``, K1 alone ran once a
               bucket of every warm batch, and a replay of the
               reference mix's covered requests gives ``plan_hit`` 1.0,
               ``jit_compiles`` 0 and the CPU's answers; the prewarm's
               seconds and K1's launches are logged.  (c) Host syncs on
               the card of the batch route (the audit's pinned graphs),
               the local route at rmat16 and one size flush of the
               prewarmed server: torch's sync debug mode
               (``host_syncs``) and the op recorder's census of the same
               run, beside the CPU census and the AST sites of the
               route's functions, each answer checked.
 13. gnn_zoo — the rest of the GNN family, every segment sum on K4.
               (a) ``segment_softmax`` on the card with its denominator
               on K4 (the reference's three fixtures; an RMAT hub of
               2,779 in-edges at 8 heads), launched twice (equal bits,
               one K4 launch a call), within 1e-5 of its plain version in
               float64.  Then at full width, float32, AdamW, random
               weights from seed 0: (b) GAT-Cora (2 layers, 8 x 8 heads,
               1,433 features, 7 classes) on Cora's shape through
               ``launch/train.py``'s pieces; (c) GAT on a ``minibatch_lg``
               block (1,024 seeds, fanouts 15 and 10: 169,984 nodes,
               168,960 slots, d_in 602) drawn on the card by
               ``GNNSampledStream`` from Reddit's 232,965 nodes (602
               float32 features on the card, an RMAT topology of edge
               factor 16 folded onto them), equal bit for bit to the
               CPU's block for the same draws, the milliseconds to
               sample one block logged; (d) SchNet (3 interactions, d 64,
               300 centres) and (e) DimeNet (6 blocks, d 128, 8 bilinear,
               7 x 6 bases, 131,072 triplet slots; ``build_triplets``'s
               host seconds and real triplets logged) on the molecule
               shape (128 graphs of 30 atoms, at most 64 edges each).
               Each: the first step's loss and every gradient against
               the CPU's plain path within 1e-4 (1 + |cpu|), a warm-up
               step, one step with the launch counters set to 0 just
               before and read just after (K4 alone: 4, 4, 4 and 8
               launches), 20 timed steps (ms, steps/s, the loss falling,
               peak memory), one profiled (busy share, top kernels), one
               with every K4 call recorded and timed beside its bound,
               its plain version (compared) and ``index_add_``, and the
               step's model FLOPs (3 x the registry's forward formula).
 14. lm_train — smollm-135m trained at full width and depth (30
               layers, d_model 576, vocab 49,152; float32, AdamW, random
               weights from seed 0).  (a) K5's backward against its plain
               version on the same CUDA tensors, each also against
               float64, launched twice (equal bits), each pass's device
               ms from one profiled window of calls, beside the forward's
               log-sum-exp against the plain one, SDPA's backward and the
               bound, and K5's forward with the log-sum-exp (device ms,
               bound, SDPA's forward), at smollm's training shape (B 4,
               Hq 9, Hkv 3, S = T 4,096, D 64), qwen2-moe's (B 2, 16
               heads, D 128), a gemma3-1b local layer (D 256, window 512,
               GQA 4:1), smollm's in bf16 and two ragged ones in bf16 (S 1,000,
               window 300, GQA 2:1, D 64 and 128).  (b) The first step
               on the card against the CPU's plain path on the same
               weights and a B 1 x S 256 batch: the loss and every
               gradient leaf within 1e-4 (1 + |cpu|), K5's forward twice
               a layer (remat) and its backward once.  (c) Through
               ``launch/train.py``'s pieces at B 4 x S 4,096 (train_4k's
               sequence, its global batch cut to 4): a warm-up step, one
               step with the launch counters set to 0 just before and
               read just after (K5 60, K5's backward 30), 20 timed steps
               (ms, tokens/s, the loss falling, peak memory, model
               TFLOP/s), one profiled (busy share, K5's forward and
               backward device ms a step).
 15. moe     — qwen2-moe-a2.7b at full width (d_model 2,048, 60 routed
               experts in 64 slots, top 4, 4 shared as one 5,632-wide GLU;
               float32, random weights from seed 0, drawn a layer at a
               time).  (a) Served at full depth (24 layers) through
               ``launch/serve.py``'s ``serve`` with the default request
               (batch 4, prompt 32, 16 generated): a warm-up, 3 serves
               (the first with the launch counters set to 0 just before
               and read just after: K5 and K4 alone, 24 each a step),
               the ids equal across them; prefill ms, decode ms a step,
               tokens/s, peak memory, busy share, the dropped fraction of
               (token, expert) entries at prefill and at decode (capacity
               1 there, as in the reference); layer 0's MoE FFN against
               the CPU on the same weights and input (routing integers
               equal, output within 1e-4 (1 + |cpu|)); every K4 launch of
               a prefill and a decode step timed beside its bound, its
               plain version and ``index_add_``.  (b) Trained at 2 layers
               (the depth cut for AdamW's memory): the first step against
               the CPU on a B 1 x S 128 batch as in 14 (b), then as 14 (c)
               at B 2 x S 4,096 with 10 timed steps (K5 4, its backward 2,
               K4 4 a step), the aux loss logged, and every K4 launch of
               one step timed.
 16. bst     — the recsys BST at full width (embed_dim 32, 20 items,
               one block of 8 heads, MLP 1,024-512-256, a 1,048,576-row
               item table and a 65,536-row profile table; float32, AdamW,
               random weights from seed 0) through ``launch/steps.py``
               and ``launch/train.py``'s pieces.  (a) At batch 512, the
               card's logits, loss, every gradient leaf and one AdamW
               step against the CPU's plain path on the same weights and
               batch, within 1e-4 (1 + |cpu|).  (c) ``bst_serve_step`` at
               512 and 262,144: a warm-up, one serve as a main path (K4
               alone, once: the profile bags), 5 timed (ms, samples/s,
               peak memory), the first 4,096 rows against the CPU.  (d)
               ``bst_retrieval_step`` over 1,000,000 candidates in slices
               of 262,144: a main path (no kernel of the port: the
               profile vector is zero), 3 timed (seconds, candidates/s,
               peak memory), the first 4,096 scores against the CPU's.
               (b) Training at batch 65,536 through ``BSTStream``: a
               warm-up step, one step as a main path (K4 alone, once), 20
               timed steps (ms, samples/s, the loss falling, peak
               memory), one profiled (busy share, K4's device ms), one
               with its K4 launch recorded and timed beside its bound,
               its plain version (within 1e-5 (1 + S) of float64, bit
               for bit across launches) and ``index_add_``.  (e) The
               whole bag function at that shape (the gather, the layout,
               K4) against ``F.embedding_bag(mode="sum")``.  (f)
               ``cover-edge-tc``'s ``rmat_smoke`` through Algorithm 2 in
               the config's ring mode over ``LocalShards(8, "cuda")``,
               equal to the local count.
 17. a2a     — qwen2-moe-a2.7b's explicit expert parallelism
               (``models/moe_a2a.py``) at full width and the training
               depth cut of 2 layers (float32, random weights from seed
               0), ``dispatch="a2a"`` under a (data 1, model 4) layout
               over ``LocalShards(4, "cuda")``.  (a) Layer 0's MoE FFN
               on a [4, 32, 2,048] input against the CPU's a2a path on
               the same weights (each slice's routing integers equal,
               output and aux within 1e-4 (1 + |cpu|)), each slice's
               dropped share beside the sort path's; the default
               request's prefill (batch 4, prompt 32) as a main path (K5
               and K4 alone, 2 each) and timed a2a against the sort path
               in turns; the first training step against the CPU's a2a
               path at B 1 x S 128 as in 14 (b); training at B 2 x S
               4,096 through ``launch/train.py``'s pieces: a warm-up,
               one step as a main path (K5 4, its backward 2, K4 4), 6
               timed steps a path in turns, one profiled; every K4
               launch of a prefill and of a step timed beside its bound,
               its plain version and ``index_add_``.  (b)
               ``int8_compressed_psum`` over ``LocalShards(8, "cuda")``
               on eight per-shard copies of a GatedGCN-sized gradient
               tree with unequal absmax: equal bit for bit to the CPU's,
               its ms a call, its error against the exact float64 sum.
               (c) The dry run of every cell on ``pod`` and ``multipod``
               on the host: cells, skips, seconds; the cells whose
               per-device argument bytes exceed the card's memory.
 18. summary — one JSON line per kernel, the card's name and power
               limit, and the final ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package.  Without a usable card,
or without the repository around it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM at the 700 W limit: HBM rate from NVIDIA's data sheet; int32
#: rate from the H100 architecture white paper, 64 INT32 lanes per SM x
#: 132 SMs x the 1.98 GHz boost clock (the data sheet gives none)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

#: expected (triangles, horizontal queries) of rmat(s, 16, seed=0):
#: scales 10 and 12 as the JAX package records them
#: (results/BENCH_tc.json), 16 and 20 from an independent scipy count
#: (ROADMAP Queue 3)
EXPECTED = {
    10: (75682, 8139),
    12: (483937, 26048),
    16: (15673932, 528985),
    20: (424277826, 8074612),
}

SAMPLE_ROWS = 4096


def log(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def sh(*cmd: str) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def sass_census(lib: str) -> dict:
    """Each kernel of a built library (``attn_bwd_dkdv_mma<64>``) with
    its count of tensor-core products (HMMA), float32 FMAs (FFMA) and
    atomics (ATOM, ATOMS, ATOMG, RED), from ``cuobjdump -sass``."""
    from repro_torch.kernels import build

    tool = str(Path(build.nvcc_path()).resolve().with_name("cuobjdump"))
    census: dict = {}
    counts = None
    for line in sh(tool, "-sass", lib).splitlines():
        fn = re.search(r"Function : \S*?\d+(attn_\w+?)ILi(\d+)E(f|13__nv_bf)?",
                       line)
        if fn:
            kind = {"f": ", float", "13__nv_bf": ", bf16"}.get(fn[3], "")
            counts = census.setdefault(f"{fn[1]}<{fn[2]}{kind}>",
                                       {"HMMA": 0, "FFMA": 0, "atomics": 0})
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if op and counts is not None:
            if op[1] in ("HMMA", "FFMA"):
                counts[op[1]] += 1
            elif op[1] in ("ATOM", "ATOMS", "ATOMG", "RED"):
                counts["atomics"] += 1
    return census


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs after
    one warm-up, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = 10, spin: int = 20_000_000) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, from CUDA events, with the host's enqueue hidden: the card
    spins (``torch.cuda._sleep(spin)``, ~10 ms at the default) before the
    start event while the host queues every run.  A run that syncs inside
    waits for the spin and counts its host time all the same."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(nbytes: int, nops: int, ls, ll, row_bytes: int) -> dict:
    """A call's least time on the card: ``bound_ms`` is the larger of
    ``nbytes`` over HBM's 3.35 TB/s and ``nops`` over the card's int32
    rate (``bound_by`` says which).  ``search_ops`` is what a binary
    search of each clamped target needs, a compare and a select for each
    of its ``ceil(log2(l_l + 1))`` steps and one equality compare per
    clamped candidate (the earlier yardstick), and
    ``search_bound_ms`` its bound over the same bytes.
    ``row_bytes_bound_ms`` is ``row_bytes`` over 3.35 TB/s: what a
    kernel that shares nothing between rows moves."""
    steps = torch.ceil(torch.log2(ll.to(torch.float64) + 1))
    s_ops = int((ls.to(torch.float64) * (2 * steps + 1)).sum().item())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=nops, search_ops=s_ops,
                search_bound_ms=max(t_bytes,
                                    s_ops / INT32_OPS_PER_S * 1e3),
                row_bytes_bound_ms=row_bytes / HBM_BYTES_PER_S * 1e3)


def bucket_bound(flat, levels, ops, d_cand: int, d_targ: int,
                 hits: int) -> dict:
    """K1's least time on the card for one bucket's call, from this
    run's operands (:func:`_bound`).  Bytes: each input read once and
    each output written once — the flat adjacency, the level array, five
    int32 operands and two int32 outputs per row.  Operations: what the
    inputs need, one membership test per clamped candidate cell and one
    level compare per hit (``hits``).  Row bytes: each row's clamped
    candidates, their levels and its clamped target list, (2 l_s + l_l)
    int32, plus 8 B out per row."""
    s_s, l_s, s_l, l_l, lev_u = ops
    ls = l_s.clamp(0, d_cand).to(torch.int64)
    ll = l_l.clamp(0, d_targ).to(torch.int64)
    q = s_s.shape[0]
    once = (flat.numel() + levels.numel()) * 4 + q * 7 * 4
    rows = int(((2 * ls + ll) * 4).sum().item()) + q * 8
    return _bound(once, int(ls.sum().item()) + hits, ls, ll, rows)


def hits_bound(flat, ops, d_cand: int, d_targ: int) -> dict:
    """K2's least time on the card for one bucket's call, from this run's
    operands (:func:`_bound`), with its ``cells``.  Bytes: the flat
    adjacency, four int32 operands (s_s, l_s, s_l, l_l) and the int64
    offset in per row, and one byte out per clamped candidate.
    Operations: one membership test per clamped candidate cell.  Row
    bytes: each row's clamped candidates and clamped target list, (l_s +
    l_l) int32, plus its operands, offset and output bytes."""
    s_s, l_s, s_l, l_l = ops[:4]
    ls = l_s.clamp(0, d_cand).to(torch.int64)
    ll = l_l.clamp(0, d_targ).to(torch.int64)
    q = s_s.shape[0]
    cells = int(ls.sum().item())
    once = flat.numel() * 4 + q * 4 * 4 + (q + 1) * 8 + cells
    rows = int(((ls + ll) * 4).sum().item()) + q * (4 * 4 + 8) + cells
    return dict(_bound(once, cells, ls, ll, rows), cells=cells)


def covered_slots(n_slots: int, ranges) -> int:
    """How many of the ``n_slots`` flat entries the ``(starts, lengths)``
    int32 ranges cover, each entry counted once (a difference array)."""
    dev = ranges[0][0].device
    d = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    for starts, lens in ranges:
        live = lens > 0
        s0 = starts[live].to(torch.int64)
        one = torch.ones_like(s0, dtype=torch.int32)
        d.index_add_(0, s0, one)
        d.index_add_(0, s0 + lens[live].to(torch.int64), -one)
    return int((d.cumsum(0)[:n_slots] > 0).sum().item())


def count_bound(flat, ops, d_cand: int, d_targ: int) -> dict:
    """K3's least time on the card for one call, from this run's
    operands (:func:`_bound`).  Bytes: every flat entry that some row's
    clamped candidate list, or the clamped target list of a row with
    candidates, covers, read once (the union over the rows: all of the
    adjacency at most, a sliver of it for a stream probe), four int32
    operands (s_s, l_s, s_l, l_l) in and one int32 count out per row.
    Operations: one membership test per clamped candidate cell.  Row
    bytes: each row's clamped candidates and clamped target list, (l_s +
    l_l) int32, plus its operands and output."""
    s_s, l_s, s_l, l_l = ops[:4]
    ls = l_s.clamp(0, d_cand)
    ll = l_l.clamp(0, d_targ)
    q = s_s.shape[0]
    # a row without candidates needs no target list
    lt = torch.where(ls > 0, ll, torch.zeros_like(ll))
    once = (covered_slots(flat.numel(), ((s_s, ls), (s_l, lt))) * 4
            + q * 5 * 4)
    ls, ll = ls.to(torch.int64), ll.to(torch.int64)
    rows = int(((ls + ll) * 4).sum().item()) + q * 5 * 4
    return _bound(once, int(ls.sum().item()), ls, ll, rows)


def compare_count(flat, ops, kw, levels=None, path="auto"):
    """``(max |K3 - plain|, max |K3 - (c1 + c2)|, hits, plain_ms)`` over
    every row: K3 by ``path`` against its plain version (timed with CUDA
    events) and, given ``levels`` (``ops[4]`` K1's ``lev_u``), against
    K1's per-row c1 + c2 on the same rows (0 without); these launches
    are comparisons, not the main path."""
    from repro_torch.kernels.intersect.intersect import (
        intersect_count,
        intersect_levels,
    )
    from repro_torch.kernels.intersect.ref import intersect_count_ref

    k = intersect_count(flat, *ops[:4], path=path, **kw)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    r = intersect_count_ref(flat, *ops[:4], **kw)
    stop.record()
    torch.cuda.synchronize()
    if not len(k):
        return 0, 0, 0, start.elapsed_time(stop)
    err12 = 0
    if levels is not None:
        c1, c2 = intersect_levels(flat, *ops[:4], levels, ops[4], **kw)
        err12 = int((k - c1 - c2).abs().max().item())
    return (int((k - r).abs().max().item()), err12, int(k.sum().item()),
            start.elapsed_time(stop))


def capture_counts(run, name: str = "intersect_count"):
    """``run()`` with every call of the probe engine's ``name`` (K3, K2
    with ``"intersect_hits"``, K1 with ``"intersect_levels"``) recorded:
    ``(result, [(flat, (s_s, l_s, s_l, l_l, *rest), d_cand, d_targ)])``
    in launch order, ``rest`` K1's ``(level, lev_u)``.  Each call still
    launches its kernel as it would."""
    from repro_torch.core import intersect as tint

    real, calls = getattr(tint, name), []

    def record(flat, s_s, l_s, s_l, l_l, *rest, d_cand, d_targ):
        calls.append((flat, (s_s, l_s, s_l, l_l, *rest), d_cand, d_targ))
        return real(flat, s_s, l_s, s_l, l_l, *rest, d_cand=d_cand,
                    d_targ=d_targ)

    setattr(tint, name, record)
    try:
        res = run()
    finally:
        setattr(tint, name, real)
    return res, calls


def time_hits_calls(calls) -> dict:
    """K2 on each recorded call (:func:`capture_counts`) by the rule by
    shape and with every row forced onto each path: host-paced
    milliseconds from CUDA events (mean of 3 after a warm-up; the call
    reads its size back) and the device milliseconds of one profiled
    call; each path's output equal to the rule's.  One log line per
    launch and the sums over the launches."""
    from repro_torch.kernels.intersect.intersect import intersect_hits

    paths = ("auto",) + PATHS_TIMED
    k2 = dict(launches=len(calls), rows=0, cells=0, max_abs_err=0,
              host_paced_ms=dict.fromkeys(paths, 0.0),
              device_ms=dict.fromkeys(paths, 0.0))
    for i, (flat, ops, d_cand, d_targ) in enumerate(calls):
        kw = dict(d_cand=d_cand, d_targ=d_targ)
        want = intersect_hits(flat, *ops, **kw)
        host, dev = {}, {}
        for p in paths:
            host[p] = cuda_ms(lambda: intersect_hits(flat, *ops, path=p,
                                                     **kw))
            dev[p] = profiled_ms(lambda: intersect_hits(flat, *ops, path=p,
                                                        **kw))[0]
            got = intersect_hits(flat, *ops, path=p, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                k2["max_abs_err"] = 1
            k2["host_paced_ms"][p] += host[p]
            k2["device_ms"][p] += dev[p]
        cells = int(want[0][-1].item())
        k2["rows"] += len(ops[0])
        k2["cells"] += cells
        log("stream_k2_launch", launch=i, rows=len(ops[0]), cells=cells,
            d_cand=d_cand, d_targ=d_targ, host_paced_ms=host, device_ms=dev,
            **layout_stats(ops, SimpleNamespace(d_cand=d_cand,
                                                d_targ=d_targ)))
    return k2


#: device_ms's spin for one K3 call (~25 ms): longer than the host needs
#: to queue its timed launches, a bitmap layout's ~70 ops each included
K3_SPIN = 50_000_000


def k3_kernels(per: dict) -> dict:
    """The entries of a profiled run's device time by name that are
    kernels of ``intersect.cu``: K3's where the run launches neither K1
    nor K2 (a stream apply without credit): ``count_tiles``, the row
    walk (``walk_rows_*``) and the bitmap items (``intersect_items``)."""
    names = ("count_tiles", "walk_rows_", "intersect_items")
    return {k: v for k, v in per.items() if any(m in k for m in names)}


def time_count_calls(calls, buffer: int) -> dict:
    """K3 on each recorded call (:func:`capture_counts`) of a session of
    ``buffer`` updates an internal batch, by the rule by shape and with
    every row forced onto each path: device milliseconds
    (:func:`device_ms`, the host's enqueue hidden, mean of 5) and
    host-paced milliseconds (CUDA events, mean of 10); every row of the
    rule's output against its plain version (timed), each path launched
    twice and equal to it; the call's bound.  One log line per launch
    (the path the rule takes, rows, cells, distinct targets) and the
    sums over the launches, per path."""
    from repro_torch.kernels.intersect.intersect import intersect_count

    paths = ("auto",) + K3_PATHS_TIMED
    k3 = dict(launches=len(calls), rows=0, cells=0, hits=0, max_abs_err=0,
              device_ms=dict.fromkeys(paths, 0.0),
              host_paced_ms=dict.fromkeys(paths, 0.0), plain_ms=0.0,
              bound_ms=0.0, search_bound_ms=0.0, row_bytes_bound_ms=0.0,
              rule_paths=dict.fromkeys(K3_PATHS_TIMED, 0))
    by_bound = []
    for i, (flat, ops, d_cand, d_targ) in enumerate(calls):
        kw = dict(d_cand=d_cand, d_targ=d_targ)
        err, _, hits, p_ms = compare_count(flat, ops, kw)
        want = intersect_count(flat, *ops, **kw)
        dev, host = {}, {}
        for p in paths:
            dev[p] = device_ms(lambda: intersect_count(flat, *ops, path=p,
                                                       **kw),
                               reps=5, spin=K3_SPIN)
            host[p] = cuda_ms(lambda: intersect_count(flat, *ops, path=p,
                                                      **kw), reps=10)
            for _ in range(2):
                got = intersect_count(flat, *ops, path=p, **kw)
                err = max(err, int((got - want).abs().max().item()))
            k3["device_ms"][p] += dev[p]
            k3["host_paced_ms"][p] += host[p]
        bd = count_bound(flat, ops, d_cand, d_targ)
        st = layout_stats(ops, SimpleNamespace(d_cand=d_cand, d_targ=d_targ),
                          k3=True)
        k3["rule_paths"][st["path"]] += 1
        for key, v in (("plain_ms", p_ms), ("bound_ms", bd["bound_ms"]),
                       ("search_bound_ms", bd["search_bound_ms"]),
                       ("row_bytes_bound_ms", bd["row_bytes_bound_ms"]),
                       ("hits", hits), ("rows", len(ops[0])),
                       ("cells", st["live_cells"])):
            k3[key] += v
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        by_bound.append((bd["bound_ms"], bd["bound_by"]))
        log("stream_k3_launch", buffer=buffer, launch=i, rows=len(ops[0]),
            d_cand=d_cand, d_targ=d_targ, flat_slots=flat.numel(),
            hits=hits, device_ms=dev, host_paced_ms=host, plain_ms=p_ms,
            max_abs_err_all_rows_paths_and_repeat=err, **bd, **st)
    k3["bound_by"] = max(by_bound)[1] if by_bound else None
    return k3


def mutation_batch(rng, edges: np.ndarray, n: int, k: int):
    """``k`` mixed updates as an ``(ops, edges)`` pair: half deletes of
    distinct live edges (``edges``, the current ``(lo, hi)`` rows), half
    inserts of uniformly random pairs (a pair already present comes back
    ``noop-present``, a self pair ``noop-self-loop``), shuffled."""
    n_del = min(k // 2, edges.shape[0])
    take = rng.choice(edges.shape[0], n_del, replace=False)
    ins = rng.integers(0, n, size=(k - n_del, 2))
    ops = np.r_[-np.ones(n_del, np.int8), np.ones(k - n_del, np.int8)]
    rows = np.r_[edges[take], ins]
    order = rng.permutation(k)
    return ops[order], rows[order]


def host_syncs(run) -> int:
    """How many synchronizing CUDA operations ``run()`` makes, as
    ``torch.cuda.set_sync_debug_mode`` reports them (one warning each)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def compare_hits(flat, ops, b, rows=None, path="auto"):
    """``(max |kernel - plain|, hits, kernel_ms, plain_ms)`` of K2's
    ragged mask (offsets and bytes) over ``rows`` (all if None), both
    timed once with CUDA events, the kernel by ``path``; these launches
    are comparisons, not the main path."""
    from repro_torch.kernels.intersect.intersect import intersect_hits
    from repro_torch.kernels.intersect.ref import intersect_hits_ref

    ops = ops[:4] if rows is None else tuple(x[rows] for x in ops[:4])
    kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    ko, kh = intersect_hits(flat, *ops, path=path, **kw)
    ev[1].record()
    ev[2].record()
    ro, rh = intersect_hits_ref(flat, *ops, **kw)
    ev[3].record()
    torch.cuda.synchronize()
    err = 0
    if not torch.equal(ko, ro):
        err = max(err, int((ko - ro).abs().max().item()))
    if kh.shape != rh.shape:
        err = max(err, 1)
    elif kh.numel():
        err = max(err, int((kh.to(torch.int8) - rh.to(torch.int8))
                           .abs().max().item()))
    return (err, int(kh.sum().item()), ev[0].elapsed_time(ev[1]),
            ev[2].elapsed_time(ev[3]))


def check_found(tri, g, n: int):
    """Every row of ``tri`` a triangle of ``g``, each once: rows sorted,
    packed into int64 keys ``a<<40 | b<<20 | c`` (vertex ids < 2**20) and
    checked unique; each of the three edges looked up among the CSR's
    sorted ``src * n + dst`` keys.  Returns ``(unique, closed)``."""
    t = torch.sort(tri, dim=1).values
    col = [t[:, i].to(torch.int64) for i in range(3)]
    keys = torch.sort((col[0] << 40) | (col[1] << 20) | col[2]).values
    unique = bool((keys[1:] != keys[:-1]).all().item())
    del keys
    slots = g.src.to(torch.int64) * n + g.dst
    closed = True
    for a, b in ((0, 1), (0, 2), (1, 2)):
        k = col[a] * n + col[b]
        i = torch.searchsorted(slots, k).clamp_(max=slots.numel() - 1)
        closed &= bool((slots[i] == k).all().item())
    return unique, closed


def device_busy(run):
    """One ``run()`` under ``torch.profiler``: ``(busy_ms, wall_s, top,
    per_name_ms)``, the summed durations of every CUDA kernel, copy and
    fill (one stream, so they do not overlap), the profiled wall time,
    the five largest by name, and every name's milliseconds.  Only the
    device is traced: host events add nothing to these sums, and a run
    of many small ops (a long serve) took ~90 s to post-process with
    them.  The sums read the profiler's raw records
    (``kineto_results.events()``), not ``prof.events()``, whose
    function-event tree took ~39 s to build for a long serve's ~10^5
    device records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            per[name] = per.get(name, 0.0) + e.duration_ns() / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return (sum(per.values()) / 1e3, wall,
            [(name[:60], us / 1e3) for name, us in top],
            {name: us / 1e3 for name, us in per.items()})


def bucket_operands(g, levels, plan):
    """``[(bucket, ops)]``: K1's operands of every bucket the main path
    probes, rebuilt from the count's own levels and plan."""
    from repro_torch.core import intersect as tint
    from repro_torch.core.edges import horizontal_queries

    qu, qw, *_ = horizontal_queries(g, levels, order="desc")
    adj = tint.CsrAdjacency.from_graph(g)
    out = []
    for b, base, qu_b, qw_b, bounds in tint.bucket_slices(adj, qu, qw, plan):
        out.append((b, tint.probe_operands(adj, qu_b, qw_b, bounds, base,
                                           b.count, levels)))
    return adj.flat, out


#: K1's and K2's forced paths, timed beside the rule by shape ("auto")
PATHS_TIMED = ("bitmap", "walk")
#: K3's: the same and its tiles
K3_PATHS_TIMED = PATHS_TIMED + ("tiles",)


def layout_stats(ops, b, k3: bool = False) -> dict:
    """How K1 and K2, or K3 (``k3``: the wrapper's own rule,
    ``count_path``), serve one call by the rule by shape: the path, the
    bitmap's item count, the live rows, their clamped candidate cells
    and their distinct targets."""
    from repro_torch.kernels.intersect.intersect import (
        count_path,
        item_layout,
    )

    s_s, l_s, s_l, l_l = ops[:4]
    ls = l_s.clamp(0, b.d_cand)
    live = ls > 0
    target = (s_l.to(torch.int64) << 32) | l_l.clamp(0, b.d_targ)
    if k3:
        path = count_path(s_s.shape[0], b.d_cand)
        lay = None if path != "bitmap" else item_layout(
            *ops[:4], d_cand=b.d_cand, d_targ=b.d_targ, path="bitmap")
    else:
        lay = item_layout(*ops[:4], d_cand=b.d_cand, d_targ=b.d_targ)
        path = "walk" if lay is None else "bitmap"
    return dict(path=path,
                items=0 if lay is None else int(lay.n_items[0]),
                live_rows=int(live.sum()),
                live_cells=int(ls.sum(dtype=torch.int64).item()),
                targets=int(torch.unique(target[live]).numel()))


def profiled_ms(fn) -> tuple:
    """One ``fn()`` under ``torch.profiler`` (:func:`device_busy`):
    ``(device_ms, by_name)``, the summed device time of every kernel,
    copy and fill it ran, and each name's share (the four largest)."""
    busy, _, _, per = device_busy(fn)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    return busy, {name[:48]: ms for name, ms in top}


def compare(flat, levels, ops, b, rows=None, path="auto"):
    """``(max |kernel - plain|, c1, c2, plain_ms)`` over the per-row
    c1/c2 of ``rows`` (all if None), the kernel by ``path``, the plain
    version timed with CUDA events; the kernel's launches here are
    comparisons, not the main path."""
    from repro_torch.kernels.intersect.intersect import intersect_levels
    from repro_torch.kernels.intersect.ref import intersect_levels_ref

    if rows is not None:
        ops = tuple(x[rows] for x in ops)
    s_s, l_s, s_l, l_l, lev_u = ops
    kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
    k1, k2 = intersect_levels(flat, s_s, l_s, s_l, l_l, levels, lev_u,
                              path=path, **kw)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    r1, r2 = intersect_levels_ref(flat, s_s, l_s, s_l, l_l, levels, lev_u,
                                  **kw)
    stop.record()
    torch.cuda.synchronize()
    err = max(int((k1 - r1).abs().max().item()) if len(k1) else 0,
              int((k2 - r2).abs().max().item()) if len(k2) else 0)
    return (err, int(k1.sum().item()), int(k2.sum().item()),
            start.elapsed_time(stop))


#: updates per timed apply of the stream phase: the default
#: ``TCOptions.stream_buffer``, so each apply is one internal batch
STREAM_BATCH = 4096
#: the large-buffer session's ``stream_buffer`` and updates per apply
BIG_BUFFER = 65536


def stream_phase(eng, edges, n, main_path):
    """Phase 5: the stream route at full size on ``(edges, n)``.  Every
    run is checked (launch counters, a fresh count of the session's edge
    set); returns the summary of the phase."""
    from repro_torch.api import TCOptions
    from repro_torch.core.sequential import StageClock

    dev = eng.device
    rng = np.random.default_rng(1)
    out = {}

    def only(got, name, tag):
        if got[name] == 0 or any(v for k, v in got.items() if k != name):
            raise SystemExit(f"stream {tag}: launched {got}, expected "
                             f"{name} alone")

    def timed_applies(sess, tag, count, k):
        """``count`` applies of ``k`` fresh mixed updates each, each
        timed with a stage clock; the batches are drawn from the live
        edges before each timer starts."""
        runs = []
        for i in range(count):
            batch = mutation_batch(rng, sess.state.edges(), n, k)
            clock = StageClock(dev)
            b0 = sess.batches
            t0 = time.perf_counter()
            up = sess.apply(batch, clock=clock)
            dt = time.perf_counter() - t0
            if not up.exact or up.refreshed or up.delta_triangles is None:
                raise SystemExit(f"stream {tag}: apply {i} left the exact "
                                 f"lane: {up.exact}, {up.refreshed}")
            runs.append(dict(seconds=dt, updates=k,
                             updates_per_second=k / dt,
                             internal_batches=sess.batches - b0,
                             applied=up.applied,
                             delta_triangles=up.delta_triangles,
                             stages=clock.seconds))
            log("stream_apply", session=tag, run=i, **runs[-1])
        return runs

    def check_fresh(sess, tag, per_vertex=False):
        """The session's totals against a fresh count of its edge set
        (K1; K2 with credit): ``(report, seconds, bfs_sweeps)``."""
        cur = sess.state.edges()
        o = TCOptions(per_vertex=per_vertex)
        clock = StageClock(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = eng.count((cur, n), options=o, clock=clock)
        dt = time.perf_counter() - t0
        ok = fresh.triangles == sess.triangles
        if per_vertex:
            ok &= (np.array_equal(fresh.per_vertex, sess.per_vertex)
                   and int(sess.per_vertex.sum()) == 3 * sess.triangles)
        log("stream_check", session=tag, triangles=sess.triangles,
            fresh_triangles=fresh.triangles, num_edges=sess.num_edges,
            recount_seconds=dt, recount_stages=clock.seconds,
            recount_bfs_sweeps=clock.counts.get("bfs_sweeps"), equal=ok)
        if not ok:
            raise SystemExit(f"stream {tag}: the session's totals differ "
                             f"from a fresh count")
        return fresh, dt, clock.counts.get("bfs_sweeps")

    # 5a. the session without credit: the opening refresh (K1 alone),
    # one warm-up, then the timed applies (K3 alone)
    opts = TCOptions(stream_staleness=1e9)
    sess, open_s, _, got, mem = main_path(
        lambda c: eng.stream((edges, n), options=opts))
    only(got, "intersect_levels", "open")
    m0 = sess.num_edges
    log("stream_open", session="count", seconds=open_s, launches=got,
        triangles=sess.triangles, num_edges=m0, memory=mem)
    timed_applies(sess, "warm-up", 1, STREAM_BATCH)
    runs, _, _, got, mem = main_path(
        lambda c: timed_applies(sess, "count", 8, STREAM_BATCH))
    only(got, "intersect_count", "timed applies")
    out["launches"] = got
    out["timed"] = dict(
        updates_per_second=[r["updates_per_second"] for r in runs],
        median_updates_per_second=statistics.median(
            r["updates_per_second"] for r in runs),
        median_seconds=statistics.median(r["seconds"] for r in runs),
        memory=mem)
    # K3 at the stream path's own launch shapes: the probes of as many
    # further applies as were timed, recorded as they launch; then each
    # launch timed with CUDA events, held against its plain version row
    # for row, and bounded from its operands
    _, calls = capture_counts(
        lambda: timed_applies(sess, "k3_capture", 8, STREAM_BATCH))
    k3 = time_count_calls(calls, STREAM_BATCH)
    del calls
    log("stream_k3", buffer=STREAM_BATCH, **k3)
    if not k3["launches"] or k3["max_abs_err"]:
        raise SystemExit(f"stream: K3 at the probes' shapes: {k3}")
    out["k3"] = k3
    # one apply profiled (K3's device time per batch, the busy share) and
    # one under sync debug mode (host syncs per batch)
    batch = mutation_batch(rng, sess.state.edges(), n, STREAM_BATCH)
    busy_ms, wall_s, top, per = device_busy(lambda: sess.apply(batch))
    k3_dev = k3_kernels(per)
    batch = mutation_batch(rng, sess.state.edges(), n, STREAM_BATCH)
    syncs = host_syncs(lambda: sess.apply(batch))
    out["k3_ms_per_batch"] = sum(k3_dev.values())
    out["host_syncs_per_batch"] = syncs
    log("stream_profile", busy_ms=busy_ms, profiled_seconds=wall_s,
        top_device_ms=top, k3_ms=k3_dev,
        k3_ms_per_batch=sum(k3_dev.values()), host_syncs_per_batch=syncs)
    check_fresh(sess, "count")

    # 5b. a session whose buffer holds 65,536 updates, so an apply of as
    # many is one internal batch and its delete probes have 32,768 rows:
    # its opening count (K1 alone), one warm-up and 3 timed applies (K3
    # alone), K3 at these probes' own shapes by path (the launches of one
    # further apply, recorded), then a fresh count
    big_opts = TCOptions(stream_buffer=BIG_BUFFER, stream_staleness=1e9)
    sess_big, open_big_s, _, got, _ = main_path(
        lambda c: eng.stream((edges, n), options=big_opts))
    only(got, "intersect_levels", "65,536-buffer open")
    timed_applies(sess_big, "buffer_65536 warm-up", 1, BIG_BUFFER)
    runs, _, _, got, mem = main_path(
        lambda c: timed_applies(sess_big, "buffer_65536", 3, BIG_BUFFER))
    only(got, "intersect_count", "65,536-buffer applies")
    _, calls = capture_counts(
        lambda: timed_applies(sess_big, "k3_capture_65536", 1, BIG_BUFFER))
    k3_big = time_count_calls(calls, BIG_BUFFER)
    del calls
    log("stream_k3", buffer=BIG_BUFFER, **k3_big)
    if not k3_big["launches"] or k3_big["max_abs_err"]:
        raise SystemExit(f"stream: K3 at the 65,536-buffer probes' shapes: "
                         f"{k3_big}")
    check_fresh(sess_big, "buffer_65536")
    out["buffer_65536"] = dict(
        launches=got, memory=mem, k3=k3_big, open_seconds=open_big_s,
        updates_per_second=[r["updates_per_second"] for r in runs],
        median_updates_per_second=statistics.median(
            r["updates_per_second"] for r in runs))
    del sess_big
    torch.cuda.empty_cache()

    # 5c. a second session with per-vertex credit: its opening count and
    # its timed applies go through K2 alone
    pv_opts = TCOptions(per_vertex=True, stream_staleness=1e9)
    sess_pv, open_pv_s, _, got, mem = main_path(
        lambda c: eng.stream((edges, n), options=pv_opts))
    only(got, "intersect_hits", "per-vertex open")
    log("stream_open", session="per_vertex", seconds=open_pv_s,
        launches=got, memory=mem)
    timed_applies(sess_pv, "per_vertex warm-up", 1, STREAM_BATCH)
    runs, _, _, got, mem = main_path(
        lambda c: timed_applies(sess_pv, "per_vertex", 4, STREAM_BATCH))
    only(got, "intersect_hits", "per-vertex applies")
    # K2 at these applies' own launch shapes, by path: two further
    # applies' probes, recorded as they launch
    _, calls = capture_counts(
        lambda: timed_applies(sess_pv, "k2_capture", 2, STREAM_BATCH),
        "intersect_hits")
    k2 = time_hits_calls(calls)
    del calls
    log("stream_k2", **k2)
    if not k2["launches"] or k2["max_abs_err"]:
        raise SystemExit(f"stream: K2 at the probes' shapes: {k2}")
    out["per_vertex"] = dict(
        launches=got, memory=mem, k2=k2,
        median_updates_per_second=statistics.median(
            r["updates_per_second"] for r in runs))
    check_fresh(sess_pv, "per_vertex", per_vertex=True)
    del sess_pv
    torch.cuda.empty_cache()

    # 5d. one apply of 1 % of the edges (K3 alone), then a fresh count of
    # the same final graph, then a forced refresh (K1 alone)
    k_big = m0 // 100
    runs, _, _, got, mem = main_path(
        lambda c: timed_applies(sess, "one_percent", 1, k_big))
    only(got, "intersect_count", "1 % apply")
    fresh, recount_s, sweeps = check_fresh(sess, "one_percent")
    out["one_percent"] = dict(runs[0], launches=got, memory=mem,
                              recount_seconds=recount_s,
                              recount_bfs_sweeps=sweeps)
    up, refresh_s, _, got, _ = main_path(
        lambda c: sess.apply([], refresh=True))
    only(got, "intersect_levels", "refresh")
    rep = sess.count()
    same = ((rep.triangles, rep.c1, rep.c2, rep.k, rep.num_horizontal)
            == (fresh.triangles, fresh.c1, fresh.c2, fresh.k,
                fresh.num_horizontal) and up.refreshed)
    log("stream_refresh", seconds=refresh_s, launches=got,
        c1=rep.c1, c2=rep.c2, k=rep.k, num_horizontal=rep.num_horizontal,
        equal_fresh_count=same)
    if not same:
        raise SystemExit("stream refresh: c1/c2/k/num_horizontal differ "
                         "from the fresh count")
    out["refresh_seconds"] = refresh_s
    out["open_seconds"] = open_s
    log("stream_summary", **out)
    return out


# ---------------------------------------------------------------------- LM

#: float32 rate of one H100 SXM outside the tensor cores at the 700 W
#: limit (NVIDIA's H100 data sheet: 67 TFLOP/s)
FP32_FLOPS_PER_S = 67e12

#: the tensor cores' dense rates of one H100 SXM at 700 W (NVIDIA's data
#: sheet): TF32 and bf16.  K5's prefill forms a float32 product from
#: three TF32 products (3xTF32), a bf16 product from one.
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12

#: device_ms's spin for one K5 call (~2 ms): longer than the host needs
#: to queue its timed launches
K5_SPIN = 4_000_000

#: the LM phase's requests to smollm-135m at full width: (batch, prompt
#: length, generated tokens).  "default" is the server's default;
#: "long" fills SmolLM-135M's 2,048 positions.
LM_REQUESTS = {"default": (4, 32, 16), "long": (8, 1920, 128)}

#: K5 against its plain version: the reference kernel tests' tolerances
#: (float32 sums in another order; one bf16 rounding of the output),
#: |kernel - plain| <= tol * (1 + |plain|)
K5_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

#: the card's teacher-forced logits against the CPU's, |card - cpu| <=
#: tol * (1 + |cpu|): float32 matmuls and softmax sums in other orders
#: through 30 layers
SERVE_TOL = 1e-3

#: K5 against its plain version before the serves: (b, hq, hkv, s, t, d,
#: causal, window, kv_offset, dtype).  The reference's sweep
#: (tests/test_kernel_flash_attention.py), then the models' own shapes.
K5_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, 0, torch.float32),
    (1, 4, 1, 200, 200, 64, True, 96, 0, torch.float32),
    (1, 2, 2, 128, 384, 32, True, None, 256, torch.float32),
    (1, 8, 8, 130, 130, 64, False, None, 0, torch.float32),
    (1, 1, 1, 1, 512, 128, True, None, 511, torch.float32),
    (1, 3, 3, 64, 64, 128, True, 17, 0, torch.float32),
    (1, 2, 2, 128, 128, 64, True, None, 0, torch.bfloat16),
    # smollm-135m: the long request's prefill over its cache, a decode step
    (8, 9, 3, 1920, 2048, 64, True, None, 0, torch.float32),
    (8, 9, 3, 1, 2048, 64, True, None, 2046, torch.float32),
    (8, 9, 3, 1920, 2048, 64, True, None, 0, torch.bfloat16),
    # gemma3-1b: D 256, a local layer's window of 512, prefill and decode
    (2, 4, 1, 2048, 2048, 256, True, 512, 0, torch.float32),
    (2, 4, 1, 1, 2048, 256, True, 512, 2000, torch.float32),
    (2, 4, 1, 2048, 2048, 256, True, 512, 0, torch.bfloat16),
    # the smoke configs' head widths (smollm 32, gemma3-1b 48)
    (4, 3, 1, 32, 48, 32, True, None, 0, torch.float32),
    (4, 2, 1, 32, 48, 48, True, 16, 0, torch.float32),
]


def attention_bound(q, k, kw):
    """K5's least time on the card for one call, from its operands:
    ``(bound_ms, bound_by, bytes, flops)``, the larger of (a) q and the
    output once each and the keys and values that some query row sees
    (the live key range, per batch and kv head) once each, over HBM's
    3.35 TB/s, and (b) 4 D float32 operations (the q.k and p.v
    multiply-adds) per live (query row, key) pair, over 67 TFLOP/s."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    pos = np.arange(s, dtype=np.int64) + kw["kv_offset"]
    hi = np.minimum(pos, t - 1) if kw["causal"] else np.full(s, t - 1)
    lo = (np.maximum(pos - kw["window"] + 1, 0) if kw["window"]
          else np.zeros(s, np.int64))
    live = np.clip(hi - lo + 1, 0, None)
    flops = 4 * d * b * hq * int(live.sum())
    keys = int(hi.max() - lo.min() + 1) if live.any() else 0
    nbytes = q.element_size() * (2 * b * hq * s * d + 2 * b * hkv * keys * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def tensor_core_bound_ms(q, nbytes: int, flops: int) -> float:
    """K5's least time at the rate its prefill design uses: the larger of
    the bytes over HBM's rate and the products on the tensor cores, three
    TF32 products per float32 product (3xTF32) or one bf16 product."""
    ops = (3 * flops / TF32_FLOPS_PER_S if q.dtype == torch.float32
           else flops / BF16_FLOPS_PER_S)
    return max(nbytes / HBM_BYTES_PER_S, ops) * 1e3


def within(got, want, tol: float):
    """``(max |got - want|, every element within tol * (1 + |want|))``."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol * (1 + want.float().abs())).all().item())
    return float(diff.max().item()), ok


def sdpa_call(q, k, v, kw):
    """The yardstick: one ``scaled_dot_product_attention`` call with the
    same boolean mask and GQA, on the same operands (never called by the
    port)."""
    import torch.nn.functional as F

    s, t = q.shape[2], k.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None] + kw["kv_offset"]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if kw["causal"]:
        mask &= kpos <= qpos
    if kw["window"]:
        mask &= qpos - kpos < kw["window"]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def k5_splits(q, k, kw) -> int:
    """The number of key splits of a decode call (0 for a prefill)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if s != 1:
        return 0
    units = b * hkv * -(-(hq // hkv) // fa.DECODE_ROWS)
    return fa.decode_splits(k.shape[2], kw["kv_offset"], causal=kw["causal"],
                            window=kw["window"], units=units, d=d)[2]


def time_attention_call(q, k, v, kw) -> dict:
    """K5 on one call's operands: its device milliseconds (``device_ms``,
    mean of 5 after a warm-up, the host's enqueue hidden), its host-paced
    milliseconds (``cuda_ms``: back-to-back calls of the wrapper), the
    plain version's and SDPA's on the same operands, each compared with
    the plain version, whether two launches give the same bits, and the
    bounds.  These launches are comparisons, not the main path."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ms = device_ms(lambda: flash_attention(q, k, v, **kw), reps=5,
                   spin=K5_SPIN)
    host_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    got = flash_attention(q, k, v, **kw)
    same = bool(torch.equal(got, flash_attention(q, k, v, **kw)))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = attention_ref(q, k, v, **kw)
    stop.record()
    lib = sdpa_call(q, k, v, kw)
    lib_ms = device_ms(lib, reps=5, spin=K5_SPIN)
    err, ok = within(got, want, K5_TOL[q.dtype])
    lib_err, _ = within(lib(), want, K5_TOL[q.dtype])
    bound, by, nbytes, flops = attention_bound(q, k, kw)
    del got, want
    return dict(s=q.shape[2], t=k.shape[2], kv_offset=kw["kv_offset"],
                splits=k5_splits(q, k, kw), ms=ms, host_paced_ms=host_ms,
                plain_ms=start.elapsed_time(stop), library_ms=lib_ms,
                bound_ms=bound, bound_by=by,
                tensor_core_bound_ms=tensor_core_bound_ms(q, nbytes, flops),
                bytes=nbytes, flops=flops, max_abs_err=err, within_tol=ok,
                bit_identical=same, library_max_abs_err=lib_err)


def record_attention(run, on_call):
    """``run()`` with ``on_call(q, k, v, kw)`` called after each attention
    call of the transformer (each still launches K5 as it would), while
    its operands are as the call saw them."""
    from repro_torch.kernels.flash_attention import ops

    real = ops.attention

    def hook(q, k, v, **kw):
        out = real(q, k, v, **kw)
        on_call(q, k, v, kw)
        return out

    ops.attention = hook
    try:
        return run()
    finally:
        ops.attention = real


def sum_calls(calls) -> dict:
    """Totals over recorded K5 calls (ms, plain_ms, library_ms, bound_ms,
    bytes, flops), the largest error, and what bounds the most of them."""
    out = {key: sum(c[key] for c in calls) for key in (
        "ms", "host_paced_ms", "plain_ms", "library_ms", "bound_ms",
        "tensor_core_bound_ms", "bytes", "flops")}
    out["launches"] = len(calls)
    out["max_abs_err"] = max((c["max_abs_err"] for c in calls), default=0.0)
    out["within_tol"] = all(c["within_tol"] for c in calls)
    out["bit_identical"] = all(c["bit_identical"] for c in calls)
    out["library_max_abs_err"] = max(
        (c["library_max_abs_err"] for c in calls), default=0.0)
    out["bound_by"] = max(((c["bound_ms"], c["bound_by"]) for c in calls),
                          default=(0, None))[1]
    return out


def lm_phase(dev, main_path) -> dict:
    """Phase 6: smollm-135m served at full width through K5 (see the
    module's docstring); ``main_path`` is ``main``'s.  Returns the
    phase's summary and K5's entry of the ``kernels`` line."""
    from repro_torch.configs.registry import arch_module
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.serve import prompt_tokens, serve
    from repro_torch.launch.steps import init_for

    tf32 = torch.backends.cuda.matmul.allow_tf32
    log("lm_setup", matmul_allow_tf32=tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        float32_matmul_precision=torch.get_float32_matmul_precision())
    if tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 is on: the "
                         "float32 matmuls would run in TF32")

    # 6a. K5 against its plain version over the sweep and the models' shapes
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    sweep_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, hq, hkv, s, t, d, causal, window, off, dt in K5_CASES:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((b, hq, s, d), (b, hkv, t, d),
                                 (b, hkv, t, d)))
        kw = dict(causal=causal, window=window, kv_offset=off)
        got = fa.flash_attention(q, k, v, **kw)
        err, ok = within(got, attention_ref(q, k, v, **kw), K5_TOL[dt])
        same = bool(torch.equal(got, fa.flash_attention(q, k, v, **kw)))
        sweep_err[dt] = max(sweep_err[dt], err)
        log("k5_vs_plain", b=b, hq=hq, hkv=hkv, s=s, t=t, d=d, **kw,
            dtype=str(dt), splits=k5_splits(q, k, kw), max_abs_err=err,
            tol=K5_TOL[dt], within_tol=ok, bit_identical=same)
        if not (ok and same):
            raise SystemExit(f"K5 at {(b, hq, hkv, s, t, d)}, {kw}, {dt}: "
                             f"error {err}, bit-identical {same}")
    del q, k, v, got
    log("k5_sweep", cases=len(K5_CASES), max_abs_err={
        str(k): v for k, v in sweep_err.items()},
        seconds=time.perf_counter() - t_phase)

    # 6b. serve smollm-135m at full width: a warm-up, then 3 timed serves
    # of each request, the first with the launch counters set to 0 just
    # before and read just after; one more serve profiled for the device's
    # busy share, and one with K5's launches recorded (6c)
    cfg = arch_module("smollm-135m").CONFIG
    t0 = time.perf_counter()
    model = init_for("smollm-135m", cfg, 0, dev)
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    out = {"requests": {}, "launches": {}}
    k5_calls = {}
    for tag, (b, p, gen) in LM_REQUESTS.items():
        t_req = time.perf_counter()
        tokens = prompt_tokens(cfg, b, p, dev)
        serve(model, tokens, gen)
        first, _, _, got, mem = main_path(
            lambda c: serve(model, tokens, gen))
        want = cfg.n_layers * gen
        if got["flash_attention"] != want or any(
                n for key, n in got.items() if key != "flash_attention"):
            raise SystemExit(f"serve {tag}: launched {got}; expected "
                             f"flash_attention alone, {want} times")
        runs = [first] + [serve(model, tokens, gen) for _ in range(2)]
        for r in runs:
            err, ok = within(r.logits, first.logits, SERVE_TOL)
            if (r.ids.shape != (b, gen) or not ok
                    or not bool(torch.isfinite(r.logits).all())):
                raise SystemExit(f"serve {tag}: a timed run differs from "
                                 f"the first ({err}) or is not finite")
        serve_s = time.perf_counter() - t_req
        busy_ms, wall_s, top, per = device_busy(
            lambda: serve(model, tokens, gen))
        t_rec = time.perf_counter()
        calls = []
        record_attention(lambda: serve(model, tokens, gen),
                         lambda q, k, v, kw: calls.append(
                             time_attention_call(q, k, v, kw)))
        k5_calls[tag] = calls
        record_s = time.perf_counter() - t_rec
        for i, c in enumerate(calls):
            if c["s"] > 1:
                log("k5_launch", request=tag, layer=i, **c)
        dec_calls = [c for c in calls if c["s"] == 1]
        log("k5_decode_launches", request=tag, launches=len(dec_calls),
            **{f"{key}_quantiles": [float(x) for x in np.quantile(
                [c[key] for c in dec_calls], [0, 0.5, 1])]
               for key in ("ms", "host_paced_ms", "plain_ms", "library_ms",
                           "bound_ms", "splits")})
        pre = sum_calls([c for c in calls if c["s"] > 1])
        dec = sum_calls([c for c in calls if c["s"] == 1])
        steps = gen - 1
        line = dict(
            request=tag, batch=b, prompt=p, generated=gen,
            max_len=p + gen, launches=got, memory=mem,
            kv_cache_bytes=2 * cfg.n_layers * b * (p + gen)
            * cfg.n_kv_heads * cfg.d_head * 4,
            prefill_ms=[r.prefill_s * 1e3 for r in runs],
            median_prefill_ms=statistics.median(r.prefill_s
                                                for r in runs) * 1e3,
            decode_ms_per_step=[r.decode_s / steps * 1e3 for r in runs],
            median_decode_ms_per_step=statistics.median(
                r.decode_s for r in runs) / steps * 1e3,
            decode_tokens_per_second=statistics.median(
                b * steps / r.decode_s for r in runs),
            device_busy_ms=busy_ms, profiled_seconds=wall_s,
            busy_share=busy_ms / 1e3 / wall_s,
            k5_device_ms=sum(ms for name, ms in per.items()
                             if "flash_attention" in name),
            top_device_ms=top, k5_prefill=pre, k5_decode=dec,
            seconds=dict(serves=serve_s, recorded=record_s,
                         total=time.perf_counter() - t_req))
        log("lm_serve", **line)
        if len(calls) != want or not (pre["within_tol"] and dec["within_tol"]
                                      and dec["bit_identical"]):
            raise SystemExit(f"serve {tag}: K5 on the recorded launches: "
                             f"{len(calls)} calls, prefill {pre}, decode "
                             f"{dec}")
        out["requests"][tag] = line
        out["launches"][tag] = got["flash_attention"]
        del tokens, first, runs

    # 6d. the same default request on the CPU through the plain path (same
    # weights, same ids); the card is fed the CPU's ids (teacher forcing)
    b, p, gen = LM_REQUESTS["default"]
    cpu_model = init_for("smollm-135m", cfg, 0, "cpu")
    tokens = prompt_tokens(cfg, b, p, "cpu")
    cpu, cpu_s, _, got, _ = main_path(
        lambda c: serve(cpu_model, tokens, gen))
    if any(got.values()):
        raise SystemExit(f"the CPU serve launched a kernel: {got}")
    card = serve(model, tokens.to(dev), gen, forced=cpu.ids)
    err, ok = within(card.logits.cpu(), cpu.logits, SERVE_TOL)
    top2 = cpu.logits.topk(2, dim=-1).values              # [gen, B, 2]
    decided = (top2[..., 0] - top2[..., 1]) > SERVE_TOL   # [gen, B]
    same = card.ids.cpu().T == cpu.ids.T
    ids_ok = bool((same | ~decided).all())
    log("lm_cpu_vs_card", request="default", max_abs_err=err, tol=SERVE_TOL,
        within_tol=ok, steps=gen, decided=int(decided.sum()),
        ids_equal=int(same.sum()), ids_equal_where_decided=ids_ok,
        cpu_seconds=cpu_s, cpu_ids0=cpu.ids[0].tolist())
    if not (ok and ids_ok):
        raise SystemExit(f"the card's teacher-forced serve differs from the "
                         f"CPU's: {err}, ids {ids_ok}")
    out.update(init_seconds=init_s, weight_bytes=weight_bytes,
               sweep_max_abs_err={str(k): v for k, v in sweep_err.items()},
               cpu_vs_card_max_abs_err=err)

    every = k5_calls["default"] + k5_calls["long"]
    tot = sum_calls(every)
    splits = {f"{tag}_{part}": sum_calls([c for c in k5_calls[tag]
                                          if (c["s"] > 1) == (part ==
                                                              "prefill")])
              for tag in LM_REQUESTS for part in ("prefill", "decode")}
    max_err = max(tot["max_abs_err"], sweep_err[torch.float32])
    out["kernel"] = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
        "replaces_function":
            "repro.kernels.flash_attention.flash_attention.flash_attention",
        "launches": sum(out["launches"].values()),
        "launches_default": out["launches"]["default"],
        "launches_long": out["launches"]["long"],
        "matches_plain": tot["within_tol"],
        "max_abs_err": max_err,
        "bit_identical": tot["bit_identical"],
        "ms": tot["ms"],
        "host_paced_ms": tot["host_paced_ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"],
        "tensor_core_bound_ms": tot["tensor_core_bound_ms"],
        "library_ms": tot["library_ms"],
        "decode_splits_per_launch": {tag: sorted({c["splits"] for c in
                                                  k5_calls[tag]
                                                  if c["s"] == 1})
                                     for tag in LM_REQUESTS},
        "splits": {key: {k: v[k] for k in (
            "launches", "ms", "host_paced_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "tensor_core_bound_ms", "max_abs_err")}
            for key, v in splits.items()},
        "shape": "smollm-135m at full width (Hq 9, Hkv 3, D 64, float32): "
                 "every launch of one serve of each request, timed on the "
                 "device with the host's enqueue hidden "
                 "(default: batch 4, prompt 32, 16 generated, T 48; long: "
                 "batch 8, prompt 1,920, 128 generated, T 2,048), each "
                 "held against its plain version; splits: the prefill and "
                 "decode launches of each request apart; "
                 "tensor_core_bound_ms: at 3xTF32 on 495 TFLOP/s; "
                 "library: SDPA with enable_gqa and the same boolean mask",
    }
    out["seconds"] = time.perf_counter() - t_phase
    log("lm_summary", **{k: v for k, v in out.items() if k != "requests"})
    return out


# --------------------------------------------------------------------- GNN

#: K4 against its plain version, |kernel - plain| <= tol * (1 + S) with
#: S the segment's sum of |msgs| (the scale of a float32 sum's rounding:
#: K4 adds in another order, and a hub's ~10^3 terms cancel); bf16
#: messages summed in float32.  The plain version is summed in float64 for
#: the check: in float32 on the card it adds with atomics in an order that
#: changes from run to run, and its own error on a trained step's
#: 1,123-edge hub reached 1.27e-5 (1 + S) (PERF.md), past the tolerance;
#: the float32 comparison is logged beside it.
K4_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

#: the K4 sweep: (E, N, F, dtype, ids).  ids: (lo, hi) for uniform ids in
#: [lo, hi) (below 0 and from N up are dropped), "zipf" for the
#: reference's skewed hub case, "rmat" for the destinations of
#: rmat(14, 8) (a hub of 2,779 edges, 87 chunks) or "one" for a single
#: segment that owns every edge.  The reference kernel tests' shapes
#: (tests/test_kernel_segsum.py), then bf16, negative and sentinel ids,
#: the hubs, and GatedGCN's F = 70 at run A's and run B's slot counts.
K4_CASES = [
    (1000, 300, 64, torch.float32, (-1, 300)),
    (64, 5, 8, torch.float32, (-1, 5)),
    (4096, 700, 128, torch.float32, (-1, 700)),
    (513, 129, 32, torch.float32, (-1, 129)),
    (2048, 64, 256, torch.float32, (-1, 64)),
    (5000, 257, 16, torch.float32, "zipf"),
    (131072, 16384, 70, torch.float32, "rmat"),
    (131072, 16384, 70, torch.bfloat16, "rmat"),
    (2000, 50, 70, torch.float32, "one"),
    (512, 100, 64, torch.bfloat16, (0, 100)),
    (168960, 169984, 70, torch.bfloat16, (-1, 169985)),
    (3000, 1000, 70, torch.float32, (-5, 1010)),
    (21112, 2708, 70, torch.float32, (0, 2709)),
    (168960, 169984, 70, torch.float32, (0, 169985)),
]

#: GatedGCN at full width and depth through the trainer:
#: (run, --gnn-nodes, --gnn-edges, timed steps after one warm-up).
#: A: Cora's node and edge counts (the registry's full_graph_sm); B: the
#: node and edge-slot count of the registry's minibatch_lg block (1,024
#: seeds x (1 + 15 + 150) nodes, 168,960 slots).
GNN_RUNS = [("A", 2708, 10556, 20), ("B", 169984, 84480, 10)]

#: the card's first-step loss and gradients against the CPU's,
#: |card - cpu| <= tol * (1 + |cpu|): float32 matmuls and sums in other
#: orders, and atomics in the gathers' backward, through 16 layers
GNN_TOL = 1e-4


def k4_within(got, msgs, seg, n: int, tol: float, exact: bool = True):
    """``(max |got - plain|, max |got - plain| / (1 + S), ok)``: K4's
    output against its plain version on the same operands, summed in
    float64 (``exact``) or in the operands' float32, S the segment's sum
    of |msgs| (``K4_TOL``)."""
    from repro_torch.kernels.segsum.ref import segment_sum_ref

    m = msgs.double() if exact else msgs
    diff = (got.to(m.dtype) - segment_sum_ref(m, seg, n)).abs()
    scaled = diff / (1 + segment_sum_ref(m.abs(), seg, n))
    worst = float(scaled.max().item()) if scaled.numel() else 0.0
    return (float(diff.max().item()) if diff.numel() else 0.0, worst,
            worst <= tol)


def segsum_ids(g, e: int, n: int, ids, dev):
    if ids == "zipf":
        rng = np.random.default_rng(0)
        return torch.from_numpy((rng.zipf(1.3, size=e) % n).astype(
            np.int32)).to(dev)
    if ids == "rmat":
        from repro_torch.graph import generators as gen

        edges, _ = gen.rmat(14, 8, seed=0)
        return torch.from_numpy(edges[:e, 1].astype(np.int32) % n).to(dev)
    if ids == "one":
        return torch.full((e,), n // 3, dtype=torch.int32, device=dev)
    lo, hi = ids
    return torch.randint(lo, hi, (e,), generator=g, device=dev,
                         dtype=torch.int32)


def segsum_bound(msgs, lay):
    """K4's least time on the card for one call: ``(bound_ms, bound_by,
    bytes, flops)``, the larger of (a) the valid edges' message rows,
    their perm entries, the offsets and the output once each, over HBM's
    3.35 TB/s, and (b) one float32 add per message element read, over
    67 TFLOP/s."""
    n, f = lay.num_segments, msgs.shape[1]
    valid = int(lay.offsets[-1].item())
    nbytes = valid * (f * msgs.element_size() + 4) + (n + 1) * 4 + n * f * 4
    flops = valid * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def time_segsum_call(msgs, lay, segment_sum_cuda) -> dict:
    """K4 (the wrapper ``segment_sum_cuda``) on one call's operands: its
    device milliseconds (``device_ms``), its host-paced milliseconds
    (``cuda_ms``: back-to-back calls of the wrapper), the plain version's
    (which syncs on its boolean mask) and the library yardstick's,
    ``torch.zeros(N, F).index_add_`` over the valid edges (never called
    by the port), each against the plain version, and the bound.  These
    launches are comparisons, not the main path."""
    from repro_torch.kernels.segsum.ref import segment_sum_ref
    from repro_torch.kernels.segsum.segsum import KIND_CROSSING

    n, f = lay.num_segments, msgs.shape[1]
    ms = device_ms(lambda: segment_sum_cuda(msgs, lay))
    host_ms = cuda_ms(lambda: segment_sum_cuda(msgs, lay))
    plain_ms = device_ms(lambda: segment_sum_ref(msgs, lay.seg, n), reps=3)
    got = segment_sum_cuda(msgs, lay)
    seg_v = lay.seg[lay.valid].long()
    msgs_v = msgs[lay.valid].float()

    def lib():
        return torch.zeros((n, f), device=msgs.device).index_add_(
            0, seg_v, msgs_v)

    lib_ms = device_ms(lib)
    tol = K4_TOL[msgs.dtype]
    err, scaled, ok = k4_within(got, msgs, lay.seg, n, tol)
    _, scaled32, _ = k4_within(got, msgs, lay.seg, n, tol, exact=False)
    lib_err, lib_scaled, _ = k4_within(lib(), msgs, lay.seg, n, tol)
    bound, by, nbytes, flops = segsum_bound(msgs, lay)
    return dict(e=msgs.shape[0], n=n, f=f, chunks=lay.n_chunks,
                crossing_segments=int((lay.kind == KIND_CROSSING).sum()),
                ms=ms, host_paced_ms=host_ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
                max_abs_err=err, max_scaled_err=scaled, within_tol=ok,
                max_scaled_err_vs_float32_plain=scaled32,
                bit_identical=bool(torch.equal(got, segment_sum_cuda(
                    msgs, lay))),
                library_max_abs_err=lib_err,
                library_max_scaled_err=lib_scaled)


def record_segsum(run, on_call):
    """``run()`` with ``on_call(msgs, layout, kernel)`` called after each
    K4 launch of the model (each still launches K4 as it would);
    ``kernel`` is the wrapper itself."""
    from repro_torch.kernels.segsum import segsum

    real = segsum.segment_sum_cuda

    def hook(msgs, layout):
        out = real(msgs, layout)
        on_call(msgs, layout, real)
        return out

    segsum.segment_sum_cuda = hook
    try:
        return run()
    finally:
        segsum.segment_sum_cuda = real


def sum_segsum_calls(calls) -> dict:
    out = {key: sum(c[key] for c in calls) for key in (
        "ms", "host_paced_ms", "plain_ms", "library_ms", "bound_ms", "bytes",
        "flops")}
    out["launches"] = len(calls)
    for key in ("max_abs_err", "max_scaled_err", "library_max_scaled_err",
                "max_scaled_err_vs_float32_plain"):
        out[key] = max((c[key] for c in calls), default=0.0)
    out["within_tol"] = all(c["within_tol"] for c in calls)
    out["bit_identical"] = all(c["bit_identical"] for c in calls)
    out["bound_by"] = max(((c["bound_ms"], c["bound_by"]) for c in calls),
                          default=(0, None))[1]
    return out


def gnn_cpu_check(cfg, model, loss_fn, batch, dev, arch="gatedgcn",
                  run="A", tag="gnn_cpu_vs_card") -> dict:
    """The first step's loss and every gradient of ``arch`` on the card
    against the port's CPU plain path, on the same weights and batch;
    raises past GNN_TOL.  The card's launches here are a comparison, not
    the main path; the gradients are cleared after."""
    from repro_torch.launch.steps import init_for

    cpu_model = init_for(arch, cfg, 0, "cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    cpu_loss = loss_fn(cpu_model, batch.to("cpu"))
    cpu_loss.backward()
    cpu_s = time.perf_counter() - t0
    loss = loss_fn(model, batch)
    loss.backward()
    errs, worst_rel, ok = {}, 0.0, True
    cpu_params = dict(cpu_model.named_parameters())
    for k, p in model.named_parameters():
        err, good = within(p.grad.cpu(), cpu_params[k].grad, GNN_TOL)
        errs[k] = err
        ok &= good
        p.grad = None
    loss_err, loss_ok = within(loss.detach().cpu(), cpu_loss.detach(),
                               GNN_TOL)
    worst = max(errs, key=errs.get)
    out = dict(loss_card=loss.item(), loss_cpu=cpu_loss.item(),
               loss_abs_err=loss_err, grad_max_abs_err=errs[worst],
               grad_worst_param=worst, tol=GNN_TOL,
               within_tol=bool(ok and loss_ok), cpu_seconds=cpu_s)
    log(tag, run=run, **out)
    if not out["within_tol"]:
        raise SystemExit(f"{arch} run {run}: the card's first step differs "
                         f"from the CPU's: {out}")
    return out


def gnn_phase(dev, main_path) -> dict:
    """Phase 7: GatedGCN trained at full width and depth through K4 (see
    the module's docstring); ``main_path`` is ``main``'s.  Returns the
    phase's summary and K4's entry of the ``kernels`` line."""
    from repro_torch.configs.registry import arch_module
    from repro_torch.kernels.segsum import ops as segops
    from repro_torch.kernels.segsum.ref import segment_sum_chunked_ref
    from repro_torch.kernels.segsum.segsum import (
        KIND_CROSSING,
        segment_sum_cuda,
    )
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.steps import init_for
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 is on: the "
                         "float32 matmuls would run in TF32")

    # 7a. K4 against its plain version, each case launched twice
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    sweep_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for e, n, f, dt, ids in K4_CASES:
        seg = segsum_ids(g, e, n, ids, dev)
        msgs = torch.randn((e, f), generator=g, device=dev).to(dt)
        lay = segops.build_layout(seg, n)
        got = segops.segment_sum(msgs, seg, n, layout=lay)
        again = segops.segment_sum(msgs, seg, n, layout=lay)
        err, scaled, ok = k4_within(got, msgs, seg, n, K4_TOL[dt])
        same = bool(torch.equal(got, again))
        # the kernel's order of sums in plain PyTorch gives its bits
        order = bool(torch.equal(got, segment_sum_chunked_ref(msgs, lay)))
        longest = int((lay.offsets[1:] - lay.offsets[:-1]).max().item())
        sweep_err[dt] = max(sweep_err[dt], err)
        log("k4_vs_plain", e=e, n=n, f=f, dtype=str(dt), ids=str(ids),
            longest_segment=longest, chunks=lay.n_chunks,
            crossing_segments=int((lay.kind == KIND_CROSSING).sum()),
            max_abs_err=err, max_scaled_err=scaled, tol=K4_TOL[dt],
            within_tol=ok, bit_identical=same, equals_its_order=order)
        if not (ok and same):
            raise SystemExit(f"K4 at {(e, n, f, dt, ids)}: error {err}, "
                             f"bit-identical {same}")
    del seg, msgs, lay, got, again
    log("k4_sweep", cases=len(K4_CASES), max_abs_err={
        str(k): v for k, v in sweep_err.items()},
        seconds=time.perf_counter() - t_phase)

    # 7b. GatedGCN through launch/train.py's own pieces at two sizes
    mod = arch_module("gatedgcn")
    cfg = mod.CONFIG
    out = {"runs": {}, "launches": {}, "k4": {}}
    for tag, nodes, edges, timed in GNN_RUNS:
        t_run = time.perf_counter()
        args = ltrain.parse_args([
            "--arch", "gatedgcn", "--gnn-nodes", str(nodes), "--gnn-edges",
            str(edges), "--steps", str(timed + 4), "--device", "cuda"])
        model = init_for("gatedgcn", cfg, args.seed, dev)
        loss_fn, stream = ltrain.build_gnn_pieces("gatedgcn", cfg, args)
        batch = stream.batch
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_run
        n = batch.n_nodes
        real = batch.dst < n
        deg = torch.bincount(batch.dst[real].long(), minlength=n)
        data = dict(nodes=n, slots=batch.n_edges,
                    real_edges=int(real.sum().item()),
                    isolated_nodes=int((deg == 0).sum().item()),
                    longest_segment=int(deg.max().item()),
                    feature_bytes=batch.node_feat.numel() * 4)
        log("gnn_data", run=tag, setup_seconds=setup_s, **data)
        if tag == "A":
            out["cpu_vs_card"] = gnn_cpu_check(cfg, model, loss_fn, batch,
                                               dev)
        opt = OptConfig(kind=args.opt, lr=args.lr, warmup=10,
                        total_steps=args.steps)
        trainer = Trainer(loss_fn, model, opt, cfg=cfg, log_every=10**9)
        first = trainer.fit(stream, 1)                        # warm-up
        rep, _, _, got, mem = main_path(lambda c: trainer.fit(stream, 1))
        want = 2 * cfg.n_layers
        if got["segment_sum"] != want or any(
                v for k, v in got.items() if k != "segment_sum"):
            raise SystemExit(f"gnn run {tag}: launched {got}; expected "
                             f"segment_sum alone, {want} times")
        timed_rep = trainer.fit(stream, timed)
        steps_ms = [s * 1e3 for s in timed_rep["step_seconds"]]
        history = first["history"] + rep["history"] + timed_rep["history"]
        if not (np.isfinite(history).all() and history[-1] < history[0]):
            raise SystemExit(f"gnn run {tag}: the loss did not fall: "
                             f"{history}")
        med = statistics.median(steps_ms)
        busy_ms, wall_s, top, per = device_busy(
            lambda: trainer.fit(stream, 1))
        # every K4 launch of one step, recorded and timed
        calls, layouts = [], []
        record_segsum(lambda: trainer.fit(stream, 1),
                      lambda m, lay, k: (calls.append(time_segsum_call(
                          m, lay, k)), layouts.append(lay)))
        lay = layouts[0]
        longest = int((lay.offsets[1:] - lay.offsets[:-1]).max().item())
        del layouts
        # the cost of the skew: one launch's operands grouped by uniform
        # ids in place of the RMAT destinations (same E, N, valid count)
        uni = segops.build_layout(torch.where(
            lay.valid, torch.randint(0, n, lay.seg.shape, generator=g,
                                     device=dev, dtype=torch.int32),
            lay.seg), n)
        msgs0 = torch.randn((batch.n_edges, cfg.d_hidden), generator=g,
                            device=dev)
        skew = dict(rmat_ms=device_ms(lambda: segment_sum_cuda(msgs0, lay)),
                    uniform_ms=device_ms(lambda: segment_sum_cuda(msgs0,
                                                                  uni)),
                    longest_segment=longest,
                    uniform_longest_segment=int(
                        (uni.offsets[1:] - uni.offsets[:-1]).max().item()))
        del uni, msgs0, lay
        if tag == "B":
            for i, c in enumerate(calls):
                log("k4_launch", run=tag, launch=i, **c)
        log("k4_chunks", run=tag, chunks_per_launch=calls[0]["chunks"],
            crossing_segments=calls[0]["crossing_segments"],
            longest_segment=longest, launches=len(calls))
        tot = sum_segsum_calls(calls)
        out["k4"][tag] = tot
        line = dict(
            run=tag, gnn_nodes=nodes, gnn_edges=edges, **data,
            launches=got, memory=mem, step_ms=steps_ms,
            median_step_ms=med, steps_per_second=1e3 / med,
            loss_first=history[0], loss_last=history[-1],
            steps=len(history), device_busy_ms=busy_ms,
            profiled_seconds=wall_s, busy_share=busy_ms / 1e3 / wall_s,
            busy_share_of_median_step=busy_ms / med,
            k4_device_ms=sum(ms for name, ms in per.items()
                             if "segsum" in name),
            top_device_ms=top, k4_step=tot, k4_skew=skew,
            k4_chunks=calls[0]["chunks"],
            seconds=time.perf_counter() - t_run)
        log("gnn_train", **line)
        if len(calls) != want or not (tot["within_tol"]
                                      and tot["bit_identical"]):
            raise SystemExit(f"gnn run {tag}: K4 on the recorded launches: "
                             f"{len(calls)} calls, {tot}")
        out["runs"][tag] = line
        out["launches"][tag] = got["segment_sum"]
        del model, trainer, stream, batch, loss_fn, calls
        torch.cuda.empty_cache()

    b = out["k4"]["B"]
    max_err = max(b["max_abs_err"], out["k4"]["A"]["max_abs_err"],
                  sweep_err[torch.float32])
    out["kernel"] = {
        "name": "segment_sum",
        "route": "cuda",
        "source": "src/repro_torch/kernels/segsum/csrc/segsum.cu",
        "replaces": "src/repro/kernels/segsum/segsum.py:125",
        "replaces_function":
            "repro.kernels.segsum.segsum.segment_sum_pallas",
        "launches": out["launches"]["B"],
        "launches_run_a": out["launches"]["A"],
        "matches_plain": b["within_tol"] and out["k4"]["A"]["within_tol"],
        "bit_identical": b["bit_identical"],
        "max_abs_err": max_err,
        "max_scaled_err": max(b["max_scaled_err"],
                              out["k4"]["A"]["max_scaled_err"]),
        "max_scaled_err_vs_float32_plain": max(
            b["max_scaled_err_vs_float32_plain"],
            out["k4"]["A"]["max_scaled_err_vs_float32_plain"]),
        "library_max_scaled_err": b["library_max_scaled_err"],
        "ms": b["ms"],
        "host_paced_ms": b["host_paced_ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": b["library_ms"],
        "chunks_per_launch": out["runs"]["B"]["k4_chunks"],
        "run_a": {k: out["k4"]["A"][k] for k in (
            "launches", "ms", "host_paced_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err", "max_scaled_err")},
        "shape": "GatedGCN at full width (F 70, float32): the 32 launches "
                 "of one training step of run B (169,984 nodes, 168,960 "
                 "slots), each timed and held against its plain version "
                 "summed in float64; "
                 "one launch: the chunk pass (a warp per 32 edges) and "
                 "the fix-up; "
                 "run_a: the same for run A (2,708 nodes, 21,112 slots); "
                 "library: torch.zeros(N, F).index_add_ over the valid "
                 "edges",
    }
    out["sweep_max_abs_err"] = {str(k): v for k, v in sweep_err.items()}
    out["seconds"] = time.perf_counter() - t_phase
    log("gnn_summary", **{k: v for k, v in out.items() if k != "runs"})
    return out


#: phase 8's batch: ``SERVE_LANES`` lanes of ``rmat(SERVE_SCALE, 16,
#: seed=s)``, s = 0 .. SERVE_LANES - 1
SERVE_LANES, SERVE_SCALE = 8, 16
#: phase 8's real-size serving mix: ``SERVE_MIX[0]`` requests of
#: ``rmat(scale, 16, seed=i)``, the scale drawn from ``SERVE_MIX[1] ..
#: SERVE_MIX[2]`` under seed 0
SERVE_MIX = (64, 12, 16)
SERVE_BATCH_SIZES = (1, 8, 16)


def time_batch_calls(tag: str, calls, name: str) -> dict:
    """Each recorded K1 (``name`` ``"intersect_levels"``) or K2 call of a
    batch over its lane view (:func:`capture_counts`): the wrapper call's
    device milliseconds (K1: the host's enqueue hidden; K2: one profiled
    call, since it reads its output's size back) and host-paced
    milliseconds (CUDA events), its bound, and its plain version on
    every row (timed and compared).  One log line per launch and the
    sums over the launches."""
    from repro_torch.kernels.intersect import intersect as kmod

    tot = dict(launches=len(calls), rows=0, cells=0, ms=0.0,
               host_paced_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               search_bound_ms=0.0, max_abs_err=0)
    by_bound = []
    for i, (flat, ops, d_cand, d_targ) in enumerate(calls):
        kw = dict(d_cand=d_cand, d_targ=d_targ)
        b = SimpleNamespace(d_cand=d_cand, d_targ=d_targ)
        if name == "intersect_levels":
            levels, ops5 = ops[4], (*ops[:4], ops[5])
            ms = device_ms(lambda: kmod.intersect_levels(flat, *ops, **kw))
            host = cuda_ms(lambda: kmod.intersect_levels(flat, *ops, **kw))
            err, s1, s2, plain_ms = compare(flat, levels, ops5, b)
            hits = s1 + s2
            bd = bucket_bound(flat, levels, ops5, d_cand, d_targ, hits)
        else:
            host = cuda_ms(lambda: kmod.intersect_hits(flat, *ops, **kw))
            ms = profiled_ms(lambda: kmod.intersect_hits(flat, *ops,
                                                         **kw))[0]
            err, hits, _, plain_ms = compare_hits(flat, ops, b)
            bd = hits_bound(flat, ops, d_cand, d_targ)
        st = layout_stats(ops, b)
        for key, v in (("ms", ms), ("host_paced_ms", host),
                       ("plain_ms", plain_ms), ("bound_ms", bd["bound_ms"]),
                       ("search_bound_ms", bd["search_bound_ms"]),
                       ("rows", len(ops[0])), ("cells", st["live_cells"])):
            tot[key] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        by_bound.append((bd["bound_ms"], bd["bound_by"]))
        log("serve_tc_launch", kernel=name, batch_path=tag, launch=i,
            rows=len(ops[0]), d_cand=d_cand, d_targ=d_targ,
            flat_slots=flat.numel(), hits=hits, device_ms=ms,
            host_paced_ms=host, plain_ms=plain_ms, max_abs_err_all_rows=err,
            **bd, **st)
    tot["bound_by"] = max(by_bound)[1] if by_bound else None
    return tot


def serve_tc_phase(dev, main_path, runs: int) -> dict:
    """Phase 8: the batch route and the triangle server (see the module's
    docstring); ``main_path`` is ``main``'s.  Returns the phase's summary,
    with K1's and K2's per-launch sums on the batch's lane view."""
    import dataclasses

    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.sequential import StageClock
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import from_edges_batch
    from repro_torch.launch.serve_tc import measure_serve, synth_requests

    t_phase = time.perf_counter()
    eng = TriangleEngine(device=dev)
    pv_opts = TCOptions(per_vertex=True)
    t0 = time.perf_counter()
    lanes = [gen.rmat(SERVE_SCALE, 16, seed=s) for s in range(SERVE_LANES)]
    gen_s = time.perf_counter() - t0
    # the gate: each lane's own count on the card, local route
    local = [eng.count(x) for x in lanes]
    local_pv = [eng.count(x, options=pv_opts) for x in lanes]
    log("serve_tc_data", lanes=SERVE_LANES, graph=f"rmat{SERVE_SCALE}",
        edge_rows=[len(e) for e, _ in lanes], generate_seconds=gen_s,
        triangles=[r.triangles for r in local],
        num_horizontal=[r.num_horizontal for r in local])

    def same(reps, want, pv):
        return len(reps) == len(want) and all(
            (r.triangles, r.c1, r.c2, r.num_horizontal, r.k)
            == (w.triangles, w.c1, w.c2, w.num_horizontal, w.k)
            and np.array_equal(r.levels[:len(w.levels)], w.levels)
            and not r.overflow and r.backend == "cuda"
            and (not pv or (np.array_equal(r.per_vertex, w.per_vertex)
                            and int(r.per_vertex.astype(np.int64).sum())
                            == 3 * r.triangles))
            for r, w in zip(reps, want))

    # packed once for the exact path (no meta) and the plans
    gb = from_edges_batch(lanes, grid=eng.budgets, device=dev)
    gb_exact = dataclasses.replace(gb, meta=None)
    n_buckets = {"bounded": len(eng.plan_for(gb).buckets),
                 "exact": len(eng.count_batch_raw(gb_exact).plan.buckets)}
    log("serve_tc_plan", budget=vars(gb.budget), meta=vars(gb.meta),
        bounded=[vars(b) for b in eng.plan_for(gb).buckets])
    # each path: its run from the edge lists (the exact one from the
    # packed batch), the same launches on the packed batch, the gate
    paths = {
        "bounded": (lambda c: eng.count_batch(lanes, clock=c),
                    lambda: eng.count_batch(gb), local, False,
                    "intersect_levels"),
        "exact": (lambda c: eng.count_batch(gb_exact, clock=c),
                  lambda: eng.count_batch(gb_exact), local, False,
                  "intersect_levels"),
        "per_vertex": (lambda c: eng.count_batch(lanes, options=pv_opts,
                                                 clock=c),
                       lambda: eng.count_batch(gb, options=pv_opts),
                       local_pv, True, "intersect_hits"),
    }
    out = {"batch": {}, "launch_sums": {}}
    for tag, (run, packed, want, pv, kname) in paths.items():
        reps, warm_s, _, got, mem = main_path(run)
        others = [k for k in ("intersect_levels", "intersect_hits",
                              "intersect_count") if k != kname]
        if not same(reps, want, pv):
            raise SystemExit(f"serve_tc {tag}: a lane differs from its "
                             f"local count")
        if got[kname] == 0 or any(got[k] for k in others) or (
                kname == "intersect_levels" and got[kname] != n_buckets[tag]):
            raise SystemExit(f"serve_tc {tag}: launched {got}; expected "
                             f"{kname} alone, once per bucket for K1")
        timed = []
        for i in range(runs):
            clock = StageClock(dev)
            t0 = time.perf_counter()
            r = run(clock)
            dt = time.perf_counter() - t0
            if not same(r, want, pv):
                raise SystemExit(f"serve_tc {tag}: timed run {i} differs")
            timed.append((dt, clock))
        med = statistics.median(dt for dt, _ in timed)
        med_clock = sorted(timed, key=lambda x: x[0])[len(timed) // 2][1]
        busy_ms, prof_s, top, _ = device_busy(lambda: run(None))
        line = dict(lanes=SERVE_LANES, launches=got, warm_seconds=warm_s,
                    seconds=[dt for dt, _ in timed], median_seconds=med,
                    median_run_stages=med_clock.seconds,
                    bfs_sweeps=med_clock.counts.get("bfs_sweeps"),
                    memory=mem, busy_ms=busy_ms, profiled_seconds=prof_s,
                    busy_share=busy_ms / 1e3 / med, top_device_ms=top,
                    plan_id=reps[0].plan_id,
                    graphs_per_second=SERVE_LANES / med)
        out["batch"][tag] = line
        log("serve_tc_batch", path=tag, **line)
        # every launch of this path, at its own shapes
        _, calls = capture_counts(packed, kname)
        out["launch_sums"][tag] = time_batch_calls(tag, calls, kname)
        log("serve_tc_launches", path=tag, **out["launch_sums"][tag])
        del calls
        torch.cuda.empty_cache()
    if any(v["max_abs_err"] for v in out["launch_sums"].values()):
        raise SystemExit(f"serve_tc: a lane-view launch differs from its "
                         f"plain version: {out['launch_sums']}")
    del gb, gb_exact, local, local_pv
    torch.cuda.empty_cache()

    # (b) the server over two streams, against the budget-padded loop
    rng = np.random.default_rng(0)
    n_mix, lo, hi = SERVE_MIX
    scales = rng.integers(lo, hi + 1, size=n_mix)
    t0 = time.perf_counter()
    mix = [gen.rmat(int(s), 16, seed=i) for i, s in enumerate(scales)]
    log("serve_tc_mix", requests=n_mix, scales=np.bincount(
        scales, minlength=hi + 1)[lo:].tolist(),
        generate_seconds=time.perf_counter() - t0)
    out["serve"] = {}
    # both mixes' requests, kept for phase 9's open-loop traces
    out["requests"] = {"synth_96": synth_requests(96, seed=0),
                       f"rmat{lo}_{hi}_{n_mix}": mix}
    for name, reqs in out["requests"].items():
        row, secs, _, got, mem = main_path(
            lambda c, reqs=reqs: measure_serve(
                batch_sizes=SERVE_BATCH_SIZES, device=dev, requests=reqs))
        row = dict(row, launches=got, memory=mem, seconds=secs)
        out["serve"][name] = row
        log("serve_tc_serve", stream=name, **row)
        if not row["agree"] or got["intersect_levels"] == 0:
            raise SystemExit(f"serve_tc serve {name}: agree "
                             f"{row['agree']}, launches {got}")
    out["seconds"] = time.perf_counter() - t_phase
    log("serve_tc_summary", seconds=out["seconds"],
        batch={k: {f: v[f] for f in ("median_seconds", "busy_share",
                                     "graphs_per_second")}
               for k, v in out["batch"].items()},
        serve={k: {"sequential_graphs_per_s":
                   v["sequential"]["graphs_per_s"],
                   "batched": [{f: e[f] for f in (
                       "batch_size", "graphs_per_s", "p50_ms", "p99_ms",
                       "batches", "plan_cache_hit_rate",
                       "speedup_vs_sequential")} for e in v["batched"]]}
               for k, v in out["serve"].items()})
    return out


#: phase 9's open-loop traces over phase 8's two mixes: (burst length,
#: gap seconds between bursts, deadline seconds); within a burst the
#: requests arrive 0.1 / ROBUST_RATE_HZ apart.  synth_96 takes the
#: reference's chaos smoke's shape
ROBUST_TRACES = {"synth_96": (12, 0.05, 0.05),
                 "rmat12_16_64": (16, 0.5, 1.0)}
ROBUST_RATE_HZ = 400.0
ROBUST_BATCH = 8
#: replays of each trace without and with its deadline: the spread
#: that a difference between the two must exceed
ROBUST_REPLAYS = 3
#: phase 9's chaos plan: the reference smoke's batch-path fault classes
CHAOS_PLAN = dict(malformed_every=7, oversized_every=11, oversized_nodes=600,
                  stall_batch_every=5, stall_s=0.02, fail_batch_every=6)
CHAOS_OPTIONS = dict(deadline_s=0.05, admission_tokens=16,
                     approx_samples=4096)


def robust_phase(dev, main_path, scale, edges, n, n_tri, stc) -> dict:
    """Phase 9: the approx route and robust serving (see the module's
    docstring).  ``edges, n`` is the full-size graph of RMAT ``scale``
    and ``n_tri`` its count, ``stc`` phase 8's summary (its request
    lists and batch times).  Returns the phase's summary."""
    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.wedge_baseline import wedge_triangle_count
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import from_edges, max_degree
    from repro_torch.launch import robust
    from repro_torch.launch.serve_tc import (
        RejectedRequest,
        _same,
        sequential_loop,
    )

    t_phase = time.perf_counter()
    eng = TriangleEngine(device=dev)
    out = {}

    # 9a. the approx route at full size: host numpy, no launch
    rep, secs, _, got, _ = main_path(
        lambda c: eng.count((edges, n), route="approx"))
    est = rep.approx
    out["approx"] = dict(seconds=secs, estimate=est.triangles,
                         stderr=est.stderr, ci95=est.ci95,
                         samples=est.samples, closed=est.closed,
                         wedges=est.wedges, triangles=rep.triangles,
                         exact_triangles=n_tri,
                         error_in_stderr=(est.triangles - n_tri)
                         / max(est.stderr, 1e-300),
                         plan_id=rep.plan_id, launches=got)
    log("robust_approx", graph=f"rmat{scale}", **out["approx"])
    if any(got.values()) or rep.route != "approx":
        raise SystemExit(f"robust approx: route {rep.route}, launched {got}")
    if not abs(est.triangles - n_tri) <= 4 * est.stderr:
        raise SystemExit(f"robust approx: estimate {est.triangles} is "
                         f"{out['approx']['error_in_stderr']:.2f} stderr "
                         f"from {n_tri}")
    # one rmat16 request: the approx lane beside the same request served
    # exactly (submitted alone, flushed at drain as one lane through K1,
    # its latency from submit to answer); each a median of 3 after a
    # warm-up
    e16, n16 = gen.rmat(SERVE_SCALE, 16, seed=0)
    local16 = eng.count((e16, n16)).triangles
    lane_s, served_s = [], []
    for i in range(4):
        t0 = time.perf_counter()
        r16 = eng.count_approx((e16, n16))
        lane_s.append(time.perf_counter() - t0)
        srv = eng.serve(batch_size=ROBUST_BATCH)
        srv.submit(e16, n16)
        (x16,) = srv.drain()
        if x16.route != "batched" or x16.triangles != local16 or x16.overflow:
            raise SystemExit(f"robust approx lane: the served rmat16 request "
                             f"gave {x16.route} {x16.triangles}, local "
                             f"{local16}")
        served_s.append(x16.latency_s)
    out["approx_lane"] = dict(
        graph=f"rmat{SERVE_SCALE}", seconds=lane_s[1:],
        median_seconds=statistics.median(lane_s[1:]), estimate=r16.triangles,
        stderr=r16.approx.stderr, exact_triangles=local16,
        served_exact_seconds=served_s[1:],
        served_exact_median_seconds=statistics.median(served_s[1:]))
    log("robust_approx_lane", **out["approx_lane"])

    # 9b. the wedge baseline on the card at rmat12 against the local count
    e12, n12 = gen.rmat(12, 16, seed=0)
    local12 = eng.count((e12, n12)).triangles
    g12 = from_edges(e12, n12, device=dev)
    d12 = max_degree(g12)
    wedge_triangle_count(g12, d_max=d12)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w12 = int(wedge_triangle_count(g12, d_max=d12))
    out["wedge"] = dict(graph="rmat12", d_max=d12, triangles=w12,
                        local_triangles=local12,
                        seconds=time.perf_counter() - t0)
    log("robust_wedge", **out["wedge"])
    if not w12 == local12 == EXPECTED[12][0]:
        raise SystemExit(f"robust wedge baseline: {w12}, local {local12}, "
                         f"expected {EXPECTED[12][0]}")

    def warmed(e, reqs):
        """``e`` after one unmeasured pass of ``reqs`` (its plan cache and
        pooled metas warm)."""
        warm = e.serve(batch_size=ROBUST_BATCH)
        for x in reqs:
            warm.submit(*x)
        warm.drain()
        return e

    def check_exact(server, want, tag):
        """Every exact answer equal to the loop's on its id; K1 alone."""
        exact = [r for r in server.results if r.route == "batched"]
        bad = [r.request_id for r in exact
               if not _same(r, want[r.request_id])]
        if bad:
            raise SystemExit(f"robust {tag}: ids {bad[:8]} differ from the "
                             f"sequential loop")
        return len(exact)

    def line(audit, secs, got, mem):
        s = audit["summary"]
        return dict(
            requests=audit["submitted"], wall_s=audit["wall_s"],
            seconds=secs, graphs_per_s=audit["submitted"] / audit["wall_s"],
            p50_ms=s["p50_ms"], p99_ms=s["p99_ms"],
            deadline_flushes=s["deadline_flushes"],
            size_flushes=s["size_flushes"], batches=s["batches"],
            failed_batches=s["failed_batches"],
            approx_answers=s["approx_answers"], rejected=s["rejected"],
            exact=audit["exact"], approx=audit["approx"],
            flush_cost_ewma_ms=s["flush_cost_ewma_ms"], launches=got,
            memory=mem, ok=audit["ok"])

    def k1_alone(got, tag):
        if (got["intersect_levels"] == 0 or got["intersect_hits"]
                or got["intersect_count"]):
            raise SystemExit(f"robust {tag}: launched {got}; expected K1 "
                             f"alone")

    # 9c. both mixes as burst traces, without and with deadlines: one
    # warmed engine each, ROBUST_REPLAYS replays each, the two orders
    # alternating
    out["deadlines"] = {}
    for name, reqs in stc["requests"].items():
        burst, gap, deadline = ROBUST_TRACES[name]
        trace = robust.timed_trace(reqs, arrival="burst",
                                   rate_hz=ROBUST_RATE_HZ, burst_len=burst,
                                   burst_gap_s=gap, seed=0)
        want = sequential_loop(eng, reqs)[2]
        engines = {tag: warmed(TriangleEngine(TCOptions(deadline_s=dl),
                                              device=dev), reqs)
                   for tag, dl in (("no_deadline", None),
                                   ("deadline", deadline))}
        runs = {tag: [] for tag in engines}
        for i in range(ROBUST_REPLAYS):
            for tag in (list(engines) if i % 2 == 0 else list(engines)[::-1]):
                dl = engines[tag].options.deadline_s
                server = engines[tag].serve(batch_size=ROBUST_BATCH)
                audit, secs, _, got, mem = main_path(
                    lambda c, s=server, t=trace: robust.run_chaos(s, t))
                row = dict(line(audit, secs, got, mem), deadline_s=dl,
                           burst_len=burst, burst_gap_s=gap, replay=i)
                runs[tag].append(row)
                log("robust_deadlines", stream=name, run=tag, **row)
                k1_alone(got, f"{name}/{tag}")
                n_exact = check_exact(server, want, f"{name}/{tag}")
                if not (audit["ok"] and n_exact == len(reqs)
                        and row["approx_answers"] == 0
                        and row["failed_batches"] == 0
                        and row["rejected"] == 0
                        and (dl is not None or row["deadline_flushes"] == 0)):
                    raise SystemExit(f"robust {name}/{tag}: {row}")
        for tag, rows in runs.items():
            agg = {f: [r[f] for r in rows] for f in (
                "graphs_per_s", "p50_ms", "p99_ms", "deadline_flushes",
                "size_flushes")}
            out["deadlines"][f"{name}/{tag}"] = dict(
                agg, runs=rows, launches=sum(
                    r["launches"]["intersect_levels"] for r in rows),
                **{f"median_{f}": statistics.median(v)
                   for f, v in agg.items()})

    # 9d. chaos: synth_96 under the plan's batch-path fault classes
    plan = robust.CountingFaultPlan(**CHAOS_PLAN)
    reqs = stc["requests"]["synth_96"]
    burst, gap, _ = ROBUST_TRACES["synth_96"]
    trace = robust.timed_trace(reqs, arrival="burst", rate_hz=ROBUST_RATE_HZ,
                               burst_len=burst, burst_gap_s=gap, seed=0)
    sent = [plan.mutate(i, e, m) for i, (e, m) in enumerate(reqs)]
    malformed = {i for i in range(len(reqs))
                 if robust._hits(plan.malformed_every, i)}
    loop = sequential_loop(eng, [x for i, x in enumerate(sent)
                                 if i not in malformed])[2]
    want = {}
    for i in range(len(reqs)):
        if i not in malformed:
            want[i] = loop[len(want)]
    server = warmed(TriangleEngine(TCOptions(**CHAOS_OPTIONS), device=dev),
                    reqs).serve(batch_size=ROBUST_BATCH, faults=plan)
    audit, secs, _, got, mem = main_path(
        lambda c: robust.run_chaos(server, trace, faults=plan))
    row = dict(line(audit, secs, got, mem), injected=len(plan.injected),
               injected_at=list(plan.injected), plan=CHAOS_PLAN,
               options=CHAOS_OPTIONS)
    out["chaos"] = row
    log("robust_chaos", stream="synth_96", **row)
    k1_alone(got, "chaos")
    check_exact(server, want, "chaos")
    failed = robust.ordinal_failures(
        plan, row["deadline_flushes"] + row["size_flushes"])
    cpu = TriangleEngine(TCOptions(approx_samples=CHAOS_OPTIONS[
        "approx_samples"]), device="cpu")
    bad_approx = []
    for r in server.results:
        if r.route == "approx":
            c = cpu.count_approx(sent[r.request_id], seed=r.request_id)
            if (r.approx, r.triangles) != (c.approx, c.triangles):
                bad_approx.append(r.request_id)
    rejected = {r.request_id for r in server.results
                if isinstance(r, RejectedRequest)}
    if not (audit["ok"] and row["failed_batches"] == len(plan.injected)
            == failed and row["batches"] == plan.fail_batch_every - 1
            and row["exact"] and row["approx"] and rejected == malformed
            and not bad_approx):
        raise SystemExit(f"robust chaos: {row}; rejected {sorted(rejected)}, "
                         f"approx differing from the CPU {bad_approx}")
    out["seconds"] = time.perf_counter() - t_phase
    log("robust_summary", seconds=out["seconds"],
        approx_seconds=out["approx"]["seconds"],
        approx_error_in_stderr=out["approx"]["error_in_stderr"],
        deadlines={k: {f: v[f] for f in (
            "graphs_per_s", "p50_ms", "p99_ms", "deadline_flushes",
            "size_flushes")} for k, v in out["deadlines"].items()},
        approx_lane_median_seconds=out["approx_lane"]["median_seconds"],
        served_exact_median_seconds=out["approx_lane"][
            "served_exact_median_seconds"],
        chaos={f: row[f] for f in ("exact", "approx", "rejected",
                                   "failed_batches", "injected")},
        chaos_k1_launches=got["intersect_levels"])
    return out


#: phase 10's pinned values of the reference at p = 8 (both modes): its
#: run under jax 0.9.0 on the CPU, eight forced host devices
#: (tests/test_torch_distributed.py holds the port to it)
DIST_PINNED = {
    "karate": dict(
        triangles=45, per_device=[23, 2, 3, 3, 5, 1, 6, 2],
        recv_counts=[25, 13, 14, 13, 15, 15, 21, 12],
        comm={"bfs": 9520, "splitter": 1792, "transpose": 4480,
              "hedge": 8960, "reduce": 336}, reduce_per_vertex=2240),
    "rmat10": dict(
        triangles=75682,
        per_device=[16211, 13498, 11354, 9760, 9010, 9223, 3720, 2906],
        recv_counts=[2112, 1050, 1491, 1515, 1345, 1771, 1347, 2178],
        comm={"bfs": 344064, "splitter": 1792, "transpose": 586880,
              "hedge": 1173312, "reduce": 336}, reduce_per_vertex=57680),
}
#: phase 10's shard count: p logical shards stacked on the one card
DIST_P = 8
#: rows of each hedge-round K3 launch held against its plain version
DIST_SAMPLE_ROWS = 4096


def dist_fields(r) -> dict:
    """A ``ParallelTCResult``'s integers and flags, host-side."""
    return dict(
        triangles=int(r.triangles), num_horizontal=int(r.num_horizontal),
        k=float(r.k), per_device=r.per_device.cpu().tolist(),
        recv_counts=r.recv_counts.cpu().tolist(),
        overflow=[bool(r.transpose_overflow), bool(r.hedge_overflow)],
        comm=r.comm.phase_bytes(), sweeps=r.comm.bfs_sweeps)


def comm_agrees(r, n: int, m2: int, p: int, mode: str,
                per_vertex: bool = False) -> dict:
    """``comm_report`` of one run: measured (its shard group's call
    record) == tally == modeled in every phase, else exit."""
    from repro_torch.core.comm_instrument import comm_report

    rep = comm_report(n, m2, p, sweeps=r.comm.bfs_sweeps,
                      calls=r.collectives, mode=mode, per_vertex=per_vertex)
    for ph, row in rep["phases"].items():
        if not row["measured"] == row["tally"] == row["modeled"]:
            raise SystemExit(f"distributed: comm {ph} of p={p} {mode}: "
                             f"{row}")
    return rep


def time_hedge_calls(calls, tag: str, seed: int = 0) -> dict:
    """K3 on each recorded hedge-round call (:func:`capture_counts`):
    device milliseconds (:func:`device_ms`, the host's enqueue hidden,
    mean of 3) and host-paced milliseconds (CUDA events, mean of 3) by
    the rule by shape, its bound (:func:`count_bound`), and its output
    against ``intersect_count_ref`` on every row, or on a seeded sample
    of ``DIST_SAMPLE_ROWS`` rows where the call has more (the plain
    version timed on the rows it checks, beside the kernel on the same
    rows).  One log line a launch (rows, path, items, live rows and
    cells) and the sums."""
    from repro_torch.kernels.intersect.intersect import intersect_count
    from repro_torch.kernels.intersect.ref import intersect_count_ref

    rng = np.random.default_rng(seed)
    k3 = dict(launches=len(calls), rows=0, cells=0, checked_rows=0,
              max_abs_err=0, device_ms=0.0, host_paced_ms=0.0,
              bound_ms=0.0, search_bound_ms=0.0, sample_ms=0.0,
              sample_plain_ms=0.0, rule_paths={}, bound_by=[])
    for i, (flat, ops, d_cand, d_targ) in enumerate(calls):
        kw = dict(d_cand=d_cand, d_targ=d_targ)
        q = ops[0].shape[0]
        want = intersect_count(flat, *ops, **kw)
        if q > DIST_SAMPLE_ROWS:
            idx = torch.from_numpy(np.sort(rng.choice(
                q, DIST_SAMPLE_ROWS, replace=False))).to(flat.device)
        else:
            idx = torch.arange(q, device=flat.device)
        sub = tuple(x[idx] for x in ops)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = intersect_count_ref(flat, *sub, **kw)
        stop.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(stop)
        s_ms = cuda_ms(lambda: intersect_count(flat, *sub, **kw))
        err = int((want[idx] - plain).abs().max().item()) if q else 0
        again = intersect_count(flat, *ops, **kw)
        err = max(err, int((again - want).abs().max().item()) if q else 0)
        d_ms = device_ms(lambda: intersect_count(flat, *ops, **kw), reps=3,
                         spin=K3_SPIN)
        h_ms = cuda_ms(lambda: intersect_count(flat, *ops, **kw))
        bd = count_bound(flat, ops, d_cand, d_targ)
        st = layout_stats(ops, SimpleNamespace(d_cand=d_cand, d_targ=d_targ),
                          k3=True)
        k3["rule_paths"][st["path"]] = k3["rule_paths"].get(st["path"],
                                                            0) + 1
        for key, v in (("device_ms", d_ms), ("host_paced_ms", h_ms),
                       ("bound_ms", bd["bound_ms"]),
                       ("search_bound_ms", bd["search_bound_ms"]),
                       ("sample_ms", s_ms), ("sample_plain_ms", p_ms),
                       ("rows", q), ("cells", st["live_cells"]),
                       ("checked_rows", len(idx))):
            k3[key] += v
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        k3["bound_by"].append((bd["bound_ms"], bd["bound_by"]))
        log("dist_k3_launch", mode=tag, launch=i, rows=q, d_cand=d_cand,
            d_targ=d_targ, flat_slots=flat.numel(), device_ms=d_ms,
            host_paced_ms=h_ms, checked_rows=len(idx), sample_ms=s_ms,
            sample_plain_ms=p_ms, max_abs_err=err, **bd, **st)
        del want, again, plain, sub
    k3["bound_by"] = max(k3["bound_by"])[1] if k3["bound_by"] else None
    return k3


def time_dist_hits_calls(calls, seed: int = 0) -> dict:
    """K2 on each recorded call of the distributed per-vertex run
    (:func:`capture_counts` with ``"intersect_hits"``): the device
    milliseconds of one profiled call and host-paced milliseconds (CUDA
    events, mean of 3; the call reads its size back), its bound
    (:func:`hits_bound`), and its ragged mask against
    ``intersect_hits_ref``: the offsets of every row, and the hits of
    every row or of a seeded sample of ``DIST_SAMPLE_ROWS`` rows where
    the call has more (the plain version timed on the rows it checks).
    A second launch equal to the first.  One log line a launch and the
    sums."""
    from repro_torch.kernels.intersect.intersect import intersect_hits
    from repro_torch.kernels.intersect.ref import intersect_hits_ref

    rng = np.random.default_rng(seed)
    k2 = dict(launches=len(calls), rows=0, cells=0, checked_rows=0,
              max_abs_err=0, ms=0.0, host_paced_ms=0.0, bound_ms=0.0,
              search_bound_ms=0.0, sample_plain_ms=0.0, rule_paths={},
              bound_by=[])
    for i, (flat, ops, d_cand, d_targ) in enumerate(calls):
        kw = dict(d_cand=d_cand, d_targ=d_targ)
        ops = ops[:4]
        q = ops[0].shape[0]
        offs, hits = intersect_hits(flat, *ops, **kw)
        if q > DIST_SAMPLE_ROWS:
            idx = torch.from_numpy(np.sort(rng.choice(
                q, DIST_SAMPLE_ROWS, replace=False))).to(flat.device)
        else:
            idx = torch.arange(q, device=flat.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        ro, rh = intersect_hits_ref(flat, *(x[idx] for x in ops), **kw)
        stop.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(stop)
        # every row's offset: its clamped candidates, summed
        want_offs = torch.zeros(q + 1, dtype=torch.int64, device=flat.device)
        want_offs[1:] = ops[1].clamp(0, d_cand).to(torch.int64).cumsum(0)
        err = int(not torch.equal(offs, want_offs))
        # the sampled rows' hits, read out of the launch's own mask
        ln = offs[idx + 1] - offs[idx]
        if not torch.equal(ln, ro.diff()):
            err = 1
        elif rh.numel():
            pos = (torch.repeat_interleave(offs[idx] - ro[:-1], ln)
                   + torch.arange(rh.numel(), device=flat.device))
            err = max(err, int((hits[pos].to(torch.int8)
                                - rh.to(torch.int8)).abs().max().item()))
        again = intersect_hits(flat, *ops, **kw)
        if not (torch.equal(again[0], offs) and torch.equal(again[1], hits)):
            err = max(err, 1)
        h_ms = cuda_ms(lambda: intersect_hits(flat, *ops, **kw))
        d_ms = profiled_ms(lambda: intersect_hits(flat, *ops, **kw))[0]
        bd = hits_bound(flat, ops, d_cand, d_targ)
        st = layout_stats(ops, SimpleNamespace(d_cand=d_cand, d_targ=d_targ))
        k2["rule_paths"][st["path"]] = k2["rule_paths"].get(st["path"],
                                                            0) + 1
        for key, v in (("ms", d_ms), ("host_paced_ms", h_ms),
                       ("bound_ms", bd["bound_ms"]),
                       ("search_bound_ms", bd["search_bound_ms"]),
                       ("sample_plain_ms", p_ms), ("rows", q),
                       ("cells", bd["cells"]), ("checked_rows", len(idx))):
            k2[key] += v
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        k2["bound_by"].append((bd["bound_ms"], bd["bound_by"]))
        log("dist_k2_launch", launch=i, rows=q, d_cand=d_cand,
            d_targ=d_targ, flat_slots=flat.numel(), device_ms=d_ms,
            host_paced_ms=h_ms, checked_rows=len(idx), sample_plain_ms=p_ms,
            hits=int(hits.sum().item()), max_abs_err=err, **bd, **st)
        del offs, hits, again, ro, rh
    k2["bound_by"] = max(k2["bound_by"])[1] if k2["bound_by"] else None
    return k2


def distributed_phase(dev, main_path, runs: int, scale: int, edges, n: int,
                      expect) -> dict:
    """Phase 10, distributed Algorithm 2 (module docstring) over
    ``LocalShards`` on the card; ``edges``/``n`` the full-size graph and
    ``expect`` its (triangles, horizontal queries).  Returns the phase's
    summary; exits on any disagreement."""
    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.comm_model import (
        cover_edge_comm,
        wedge_comm_bits,
    )
    from repro_torch.core.comm_instrument import measured_phase_bytes
    from repro_torch.core.sequential import StageClock
    from repro_torch.core.shards import LocalShards
    from repro_torch.core.wedge_baseline import (
        parallel_wedge_triangle_count,
        wedge_count,
    )
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import BudgetGrid, from_edges
    from repro_torch.launch.robust import FaultPlan

    t_phase = time.perf_counter()
    out = {}

    def engine(p, where=dev, **kw):
        return TriangleEngine(device=where, mesh=LocalShards(p, where), **kw)

    # (a) small graphs at p = 8, both modes, with and without credit:
    # the card equal to the port's CPU path and to the pinned values
    small = []
    for name, (e, nn) in (("karate", gen.karate()),
                          ("rmat10", gen.rmat(10, 16, seed=0))):
        pin = DIST_PINNED[name]
        m2 = int(from_edges(e, nn, device=dev).n_edges_dir.item())
        for mode in ("allgather", "ring"):
            for pv in (False, True):
                o = TCOptions(mode=mode, per_vertex=pv)
                a = engine(DIST_P).count_distributed_raw((e, nn), options=o)
                b = engine(DIST_P, "cpu").count_distributed_raw((e, nn),
                                                                options=o)
                fa, fb = dist_fields(a), dist_fields(b)
                want_comm = dict(pin["comm"])
                if pv:
                    want_comm["reduce"] = pin["reduce_per_vertex"]
                ok = (fa == fb and fa["triangles"] == pin["triangles"]
                      and fa["per_device"] == pin["per_device"]
                      and fa["recv_counts"] == pin["recv_counts"]
                      and fa["comm"] == want_comm
                      and not any(fa["overflow"]))
                if pv:
                    ca, cb = a.per_vertex.cpu(), b.per_vertex
                    ok = ok and torch.equal(ca, cb) and int(
                        ca.sum()) == 3 * fa["triangles"]
                comm_agrees(a, nn, m2, DIST_P, mode, pv)
                log("dist_small", graph=name, p=DIST_P, mode=mode,
                    per_vertex=pv, agree_cpu_and_pinned=ok, **fa)
                if not ok:
                    raise SystemExit(f"distributed: {name} {mode} pv={pv} "
                                     f"card {fa} != cpu {fb} or the pins")
                small.append(fa["triangles"])
    # rmat16 at p = 1, 2, 4, 8 equal to the local count
    e16, n16 = gen.rmat(16, 16, seed=0)
    local16 = TriangleEngine(device=dev).count((e16, n16)).triangles
    for p in (1, 2, 4, 8):
        for mode in ("allgather", "ring"):
            r = engine(p).count((e16, n16), route="distributed",
                                options=TCOptions(mode=mode))
            zero = p > 1 or r.comm.total == 0
            log("dist_rmat16", p=p, mode=mode, triangles=r.triangles,
                local=local16, comm=r.comm.phase_bytes(),
                per_device=r.per_device.tolist())
            if r.triangles != local16 or r.overflow.any or not zero:
                raise SystemExit(f"distributed: rmat16 p={p} {mode}: "
                                 f"{r.triangles} != {local16}")
    out["small_seconds"] = time.perf_counter() - t_phase

    # (b) full width: rmat{scale} on DIST_P shards of the card
    eng8 = engine(DIST_P)
    g = from_edges(edges, n, device=dev)
    m2 = int(g.n_edges_dir.item())
    full, comm_by_mode = {}, {}
    for mode in ("allgather", "ring"):
        o = TCOptions(mode=mode)

        def run(clock, o=o):
            return eng8.count_distributed_raw(g, options=o, clock=clock)

        res, warm_s, clock, launched, mem = main_path(run)
        f = dist_fields(res)
        rep = comm_agrees(res, n, m2, DIST_P, mode)
        comm_by_mode[mode] = f["comm"]
        log("dist_main_path", graph=f"rmat{scale}", p=DIST_P, mode=mode,
            seconds=warm_s, stages=clock.seconds, launches=launched,
            memory=mem, comm_report=rep, **f)
        if not (f["triangles"] == expect[0]
                and f["num_horizontal"] == expect[1]
                and not any(f["overflow"])):
            raise SystemExit(f"distributed: rmat{scale} {mode}: {f}")
        if (launched["intersect_count"] == 0
                or launched["intersect_levels"] or launched["intersect_hits"]):
            raise SystemExit(f"distributed: {mode} main path launched "
                             f"{launched}; K3 alone expected")
        timed = []
        for i in range(runs):
            clock = StageClock(dev)
            t0 = time.perf_counter()
            r = run(clock)
            dt = time.perf_counter() - t0
            if int(r.triangles) != expect[0]:
                raise SystemExit(f"distributed: timed {mode} run {i}")
            timed.append((dt, clock.seconds))
            log("dist_timed_run", mode=mode, run=i, seconds=dt,
                stages=clock.seconds)
            del r
        busy, wall, top, _ = device_busy(lambda: run(None))
        med = sorted(timed, key=lambda x: x[0])[len(timed) // 2]
        full[mode] = dict(
            median_seconds=statistics.median(dt for dt, _ in timed),
            seconds=[dt for dt, _ in timed], median_run_stages=med[1],
            launches=launched["intersect_count"], memory=mem,
            device_busy_ms=busy, profiled_wall_s=wall,
            busy_share=busy / 1e3 / wall, top_device_ms=top,
            sweeps=f["sweeps"], comm=f["comm"],
            hedge_round_buffer_bytes=rep["hedge_round_buffer_bytes"])
        log("dist_end_to_end", mode=mode, graph=f"rmat{scale}", p=DIST_P,
            **full[mode])
        del res
        torch.cuda.empty_cache()
    if comm_by_mode["allgather"]["hedge"] != comm_by_mode["ring"]["hedge"]:
        raise SystemExit(f"distributed: hedge bytes differ {comm_by_mode}")
    # one per-vertex run (mode auto: the router's choice), credit = 3T
    pv_rep, pv_s, pv_clock, pv_launched, pv_mem = main_path(
        lambda c: eng8.count(g, route="distributed",
                             options=TCOptions(per_vertex=True), clock=c))
    pv_sum = int(pv_rep.per_vertex.astype(np.int64).sum())
    log("dist_per_vertex", mode=pv_rep.options.mode, seconds=pv_s,
        stages=pv_clock.seconds, launches=pv_launched, memory=pv_mem,
        triangles=pv_rep.triangles, credit_sum=pv_sum)
    if pv_rep.triangles != expect[0] or pv_sum != 3 * expect[0]:
        raise SystemExit("distributed: per-vertex credit")
    if (pv_launched["intersect_hits"] == 0 or pv_launched["intersect_levels"]
            or pv_launched["intersect_count"]):
        raise SystemExit(f"distributed: the per-vertex main path launched "
                         f"{pv_launched}; K2 alone expected")
    pv_mode = pv_rep.options.mode
    del pv_rep
    torch.cuda.empty_cache()
    # K2 at the per-vertex run's own launch shapes, one more run
    pv_o = TCOptions(per_vertex=True)
    res, calls = capture_counts(lambda: eng8.count(
        g, route="distributed", options=pv_o), name="intersect_hits")
    if res.triangles != expect[0]:
        raise SystemExit("distributed: captured per-vertex run")
    del res
    k2 = time_dist_hits_calls(calls)
    del calls
    torch.cuda.empty_cache()
    log("dist_k2", **k2)
    if k2["max_abs_err"] or k2["launches"] == 0:
        raise SystemExit(f"distributed: K2 at the per-vertex hedge rounds' "
                         f"shapes differs from its plain version: {k2}")
    out["per_vertex"] = dict(mode=pv_mode, seconds=pv_s,
                             launches=pv_launched, memory=pv_mem)
    out["k2"] = k2
    out["full"] = full

    # (c) K3 at the hedge rounds' own launch shapes, one more run a mode
    k3 = {}
    for mode in ("allgather", "ring"):
        res, calls = capture_counts(lambda: eng8.count_distributed_raw(
            g, options=TCOptions(mode=mode)))
        if int(res.triangles) != expect[0]:
            raise SystemExit(f"distributed: captured {mode} run")
        del res
        k3[mode] = time_hedge_calls(calls, mode)
        del calls
        torch.cuda.empty_cache()
        log("dist_k3", mode=mode, **k3[mode])
        if k3[mode]["max_abs_err"] or k3[mode]["launches"] == 0:
            raise SystemExit(f"distributed: K3 at the {mode} hedge rounds' "
                             f"shapes differs from its plain version: "
                             f"{k3[mode]}")
    out["k3"] = k3
    del g
    torch.cuda.empty_cache()

    # (d) serving: an over-budget request on the route, and a stalled
    # first attempt retried in ring mode under a timeout
    class StallFirst(FaultPlan):
        def before_distributed(self, rid, attempt):
            if attempt == 0:
                super().before_distributed(rid, attempt)

    big = gen.rmat(9, 8, seed=0)
    local9 = TriangleEngine(device=dev).count(big).triangles
    grid = BudgetGrid(max_nodes=256, max_slots=2048)
    served = {}
    for tag, opts, faults in (
            ("plain", TCOptions(), None),
            ("stalled", TCOptions(distributed_timeout_s=2.0),
             StallFirst(stall_distributed_every=1, distributed_stall_s=2.3))):
        srv = engine(DIST_P, budgets=grid, options=opts).serve(
            faults=faults)
        t0 = time.perf_counter()
        srv.submit(*big)
        srv.submit(*gen.karate())
        res = {r.request_id: r for r in srv.drain()}
        s = srv.summary()
        counters = {k: s[k] for k in (
            "distributed_requests", "distributed_timeouts",
            "distributed_retries", "abandoned_distributed")}
        served[tag] = dict(seconds=time.perf_counter() - t0,
                           routes=[res[0].route, res[1].route],
                           triangles=[res[0].triangles, res[1].triangles],
                           **counters)
        log("dist_serve", case=tag, local=local9, **served[tag])
        want = (1, 1, 1, 1) if tag == "stalled" else (1, 0, 0, 0)
        if (res[0].route != "distributed" or res[0].triangles != local9
                or res[1].triangles != 45
                or tuple(counters.values()) != want):
            raise SystemExit(f"distributed: serving {tag}: {served[tag]}")
    out["serve"] = served
    time.sleep(0.5)  # the abandoned attempt runs to its end

    # (e) the wedge baseline at rmat12 beside cover-edge, same model
    e12, n12 = gen.rmat(12, 16, seed=0)
    g12 = from_edges(e12, n12, device=dev)
    t0 = time.perf_counter()
    w = parallel_wedge_triangle_count(g12, LocalShards(DIST_P, dev))
    w_s = time.perf_counter() - t0
    ce = engine(DIST_P).count_distributed_raw(
        g12, options=TCOptions(mode="allgather"))
    wires = measured_phase_bytes(w.collectives, n=n12, p=DIST_P)
    wedges = float(wedge_count(g12).item())
    m12 = int(g12.n_edges_dir.item()) // 2
    paper_ce = cover_edge_comm(n12, m12, float(ce.k), DIST_P).total_bits / 8
    paper_w = wedge_comm_bits(wedges, n12) / 8
    out["wedge"] = dict(
        seconds=w_s, triangles=int(w.triangles),
        wedges_routed=int(w.wedges_routed), overflow=bool(w.overflow),
        wedge_wire_bytes=sum(wires.values()),
        cover_edge_wire_bytes=ce.comm.total,
        wedge_paper_bytes=paper_w, cover_edge_paper_bytes=paper_ce,
        paper_ratio=paper_w / paper_ce)
    log("dist_wedge", graph="rmat12", p=DIST_P, **out["wedge"])
    if not (int(w.triangles) == int(ce.triangles) == EXPECTED[12][0]
            and not bool(w.overflow)):
        raise SystemExit(f"distributed: wedge baseline {out['wedge']}")
    out["seconds"] = time.perf_counter() - t_phase
    log("dist_summary", seconds=out["seconds"],
        small_seconds=out["small_seconds"])
    return out


#: phase 11 (a)'s trace: requests of the reference's tuning mix
#: (``benchmarks/tune_bench.py``'s input)
TUNE_SYNTH = 96
#: phase 11's sweeps: each trace and its timed replays a config
TUNE_REPEATS = {"synth_96": 3, "rmat12_16_64": 1}
#: phase 11 (b)'s configs: the default and the single-knob changes of the
#: local route (bucket widths, row quantization, the budget grid) of the
#: card's 13 (~3 s an evaluation at real size: 11 evaluations for 24);
#: the distributed route's ``hedge:ring``, ``query_chunk:256`` (2.2
#: graphs/s at rung 0 against ~20 for the rest) and the combined
#: configs are swept on (a)'s trace alone
TUNE_REAL_SPACE = ("default", "grid:128x1024xf4", "widths:8-64",
                   "row_mult:16", "widths:64", "row_mult:128")
#: phase 11 (d): requests of the real-size trace that each fresh process
#: serves, one at a time, twice
TUNE_FIRST = 3
#: phase 11 (d)'s fresh process: argv = src dir, requests' npz, profile
#: path ("" for none); prints one JSON line
TUNE_FRESH = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from repro_torch.api import TriangleEngine
from repro_torch.kernels import build
d = np.load(sys.argv[2])
reqs = [(d[f"e{i}"], int(d[f"n{i}"])) for i in range(int(d["k"]))]
torch.zeros(1, device="cuda")
torch.cuda.synchronize()  # the context is not the first request's
profile = sys.argv[3] or None
t0 = time.perf_counter()
srv = TriangleEngine(device="cuda", profile=profile).serve(
    batch_size=8, prewarm=profile is not None)
torch.cuda.synchronize()
start_s = time.perf_counter() - t0
loads = build.loads()
out = []
for _ in range(2):
    for e, n in reqs:
        srv.submit(e, n)
        r = srv.drain()[-1]
        out.append((r.triangles, r.latency_s, srv.summary()["jit_compiles"]))
print(json.dumps({"server_start_seconds": start_s,
                  "loads_at_start": loads,
                  "triangles": [t for t, _, _ in out],
                  "latency_s": [s for _, s, _ in out],
                  "jit_compiles": [j for _, _, j in out],
                  "plan_hit": srv.summary()["plan_hit"]}))
"""


def replay_trace(eng, records):
    """One replay of the trace ``records`` through a fresh server of
    ``eng`` at batch 8: ``(results, seconds)``."""
    srv = eng.serve(batch_size=8)
    t0 = time.perf_counter()
    for r in records:
        srv.submit(*r.request(), deadline_s=r.deadline_s)
    res = srv.drain()
    return res, time.perf_counter() - t0


def tune_turns(cfgs, records, rounds: int, want, dev) -> dict:
    """The sweep's default and its winner (``cfgs``, in that order)
    replayed in turns, default-winner-winner-default ``rounds`` times
    after one warm replay each, each on its own engine: graphs/s per
    replay and the ratio of the medians; every replay's answers equal to
    ``want`` by id."""
    from repro_torch.api import TriangleEngine

    engs = [TriangleEngine(c.options, budgets=c.grid, device=dev)
            for c in cfgs]
    for e in engs:
        replay_trace(e, records)
    gps = ([], [])
    for _ in range(rounds):
        for side in (0, 1, 1, 0):
            res, wall = replay_trace(engs[side], records)
            got = [r.triangles for r in sorted(res,
                                               key=lambda r: r.request_id)]
            if got != want:
                raise SystemExit(f"tune turns: {cfgs[side].label} changed "
                                 f"an answer")
            gps[side].append(len(records) / wall)
    return dict(default_graphs_per_s=gps[0], winner_graphs_per_s=gps[1],
                median_ratio=statistics.median(gps[1])
                / statistics.median(gps[0]),
                winner_faster=sum(w > d for w, d in zip(gps[1], gps[0])))


def time_tune_calls(calls, seed: int = 0) -> dict:
    """K1 on each recorded call of a served replay (:func:`capture_counts`
    with ``"intersect_levels"``): device milliseconds (:func:`device_ms`,
    the host's enqueue hidden, mean of 3) and host-paced milliseconds
    (CUDA events, mean of 3) by the rule by shape, its bound
    (:func:`bucket_bound`) and path, and its c1/c2 against
    ``intersect_levels_ref`` on every row, or on a seeded sample of
    ``DIST_SAMPLE_ROWS`` rows where the call has more (the plain version
    timed on the rows it checks), and a second launch equal to the
    first.  One log line a launch and the sums."""
    from repro_torch.kernels.intersect.intersect import intersect_levels
    from repro_torch.kernels.intersect.ref import intersect_levels_ref

    rng = np.random.default_rng(seed)
    k1 = dict(launches=len(calls), rows=0, cells=0, checked_rows=0,
              max_abs_err=0, device_ms=0.0, host_paced_ms=0.0,
              bound_ms=0.0, search_bound_ms=0.0, sample_plain_ms=0.0,
              rule_paths={}, bound_by=[])
    for i, (flat, ops, d_cand, d_targ) in enumerate(calls):
        kw = dict(d_cand=d_cand, d_targ=d_targ)
        s_s, l_s, s_l, l_l, levels, lev_u = ops
        q = s_s.shape[0]
        c1, c2 = intersect_levels(flat, *ops, **kw)
        if q > DIST_SAMPLE_ROWS:
            idx = torch.from_numpy(np.sort(rng.choice(
                q, DIST_SAMPLE_ROWS, replace=False))).to(flat.device)
        else:
            idx = torch.arange(q, device=flat.device)
        sub = tuple(x[idx] for x in (s_s, l_s, s_l, l_l))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        p1, p2 = intersect_levels_ref(flat, *sub, levels, lev_u[idx], **kw)
        stop.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(stop)
        a1, a2 = intersect_levels(flat, *ops, **kw)
        err = max((int((c1[idx] - p1).abs().max().item())
                   + int((c2[idx] - p2).abs().max().item())) if q else 0,
                  int(((a1 - c1).abs() + (a2 - c2).abs()).max().item())
                  if q else 0)
        hits = int(c1.sum().item()) + int(c2.sum().item())
        d_ms = device_ms(lambda: intersect_levels(flat, *ops, **kw), reps=3)
        h_ms = cuda_ms(lambda: intersect_levels(flat, *ops, **kw))
        bd = bucket_bound(flat, levels, (s_s, l_s, s_l, l_l, lev_u),
                          d_cand, d_targ, hits)
        st = layout_stats(ops, SimpleNamespace(d_cand=d_cand, d_targ=d_targ))
        k1["rule_paths"][st["path"]] = k1["rule_paths"].get(st["path"],
                                                            0) + 1
        for key, v in (("device_ms", d_ms), ("host_paced_ms", h_ms),
                       ("bound_ms", bd["bound_ms"]),
                       ("search_bound_ms", bd["search_bound_ms"]),
                       ("sample_plain_ms", p_ms), ("rows", q),
                       ("cells", st["live_cells"]),
                       ("checked_rows", len(idx))):
            k1[key] += v
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["bound_by"].append((bd["bound_ms"], bd["bound_by"]))
        log("tune_k1_launch", launch=i, rows=q, d_cand=d_cand,
            d_targ=d_targ, flat_slots=flat.numel(), hits=hits,
            device_ms=d_ms, host_paced_ms=h_ms, checked_rows=len(idx),
            sample_plain_ms=p_ms, max_abs_err=err, **bd, **st)
        del c1, c2, a1, a2, p1, p2, sub
    k1["bound_by"] = max(k1["bound_by"])[1] if k1["bound_by"] else None
    return k1


def tune_phase(dev, main_path, stc) -> dict:
    """Phase 11, the autotuner (module docstring) over phase 8's mixes
    (``stc``, its summary); a sweep of each trace is a main path.
    Returns the phase's summary, with K1's sums at the winner's launch
    shapes; exits on any disagreement."""
    import tempfile

    from repro_torch.api import TriangleEngine
    from repro_torch.launch.serve_tc import sequential_loop
    from repro_torch.tune import (
        TraceRecorder,
        build_profile,
        default_space,
        load_profile,
        prewarm_replay,
        read_trace,
        record_serve_trace,
        successive_halving,
        trace_signature,
    )

    t_phase = time.perf_counter()
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-tune-")
    tdir = Path(tmp.name)
    out = {"sweeps": {}, "prewarm": {}, "fresh": {}}
    # (a) the reference's tuning trace, written and read back; (b) phase
    # 8's real-size mix, recorded in memory
    t0 = time.perf_counter()
    synth = record_serve_trace(TUNE_SYNTH, seed=0, heavy_every=4,
                               batch_size=8,
                               path=str(tdir / "synth_96.jsonl"),
                               device=dev)
    back = read_trace(str(tdir / "synth_96.jsonl"))
    if [r.to_json() for r in back] != [r.to_json() for r in synth]:
        raise SystemExit("tune: the synth_96 trace does not read back")
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with TraceRecorder() as rec:
        srv = TriangleEngine(device=dev).serve(batch_size=8, recorder=rec)
        for e, n in stc["requests"]["rmat12_16_64"]:
            srv.submit(e, n, deadline_s=1e9)
        srv.drain()
    real = list(rec.records)
    traces = {"synth_96": synth, "rmat12_16_64": real}
    log("tune_traces", synth_96_seconds=synth_s,
        rmat12_16_64_seconds=time.perf_counter() - t0,
        **{name: {"requests": len(r), "signature": trace_signature(r)}
           for name, r in traces.items()})
    if (len(synth), len(real)) != (TUNE_SYNTH,
                                   len(stc["requests"]["rmat12_16_64"])):
        raise SystemExit(f"tune: recorded {len(synth)} and {len(real)} "
                         f"requests")
    full_space = default_space(device=dev)
    spaces = {"synth_96": full_space,
              "rmat12_16_64": [c for c in full_space
                               if c.label in TUNE_REAL_SPACE]}
    if sorted(c.label for c in spaces["rmat12_16_64"]) != sorted(
            TUNE_REAL_SPACE):
        raise SystemExit(f"tune: the card's space lacks one of "
                         f"{TUNE_REAL_SPACE}")
    for name, records in traces.items():
        reps = TUNE_REPEATS[name]
        space = spaces[name]
        sweep, secs, _, got, mem = main_path(
            lambda c, records=records, reps=reps: successive_halving(
                space, records, batch_size=8, repeats=reps, device=dev,
                log=lambda m, name=name: log("tune_rung", trace=name,
                                             line=m)))
        if got["intersect_levels"] == 0 or any(
                v for k, v in got.items() if k != "intersect_levels"):
            raise SystemExit(f"tune {name}: launched {got}; expected K1 "
                             f"alone")
        # the baseline's answers against the sequential loop's, by id
        _, _, want = sequential_loop(TriangleEngine(device=dev),
                                     [r.request() for r in records])
        if [w[0] for w in want] != sweep["triangles"]:
            raise SystemExit(f"tune {name}: the baseline's answers differ "
                             f"from the sequential loop's")
        base, win = sweep["baseline"], sweep["winner"]
        row = dict(
            trace=name, requests=len(records), repeats=reps, seconds=secs,
            launches=got, memory=mem, device=card,
            configs=[c.label for c in space],
            evaluations=sum(len(h["evals"]) for h in sweep["history"]),
            winner=win["label"], baseline=base, winner_row=win,
            improvement_graphs_per_s=sweep["improvement_graphs_per_s"],
            p50_reduction=sweep["p50_reduction"],
            rungs=sweep["history"])
        # the winner against the default in turns, within this call
        row["turns"] = tune_turns(
            (space[0], sweep["winner_config"]), records, reps,
            sweep["triangles"], dev)
        log("tune_sweep", **row)
        out["sweeps"][name] = row
        # (c) the winner's profile, saved, loaded and prewarmed
        prof = build_profile(sweep["winner_config"], records, objective=dict(
            device=card, trace=name, graphs_per_s=win["graphs_per_s"],
            p50_ms=win["p50_ms"], p99_ms=win["p99_ms"],
            baseline_graphs_per_s=base["graphs_per_s"],
            improvement_graphs_per_s=sweep["improvement_graphs_per_s"]))
        path = prof.save(str(tdir / f"{name}.json"))
        loaded = load_profile(path)
        if loaded is None or loaded.to_json() != prof.to_json():
            raise SystemExit(f"tune {name}: the saved profile does not "
                             f"load back")
        t0 = time.perf_counter()
        pw = prewarm_replay(loaded, records, batch_size=8, device=dev)
        pw_row = dict(trace=name, seconds=time.perf_counter() - t0,
                      cells=len(loaded.cells),
                      **{k: pw[k] for k in ("plan_hit", "jit_compiles",
                                            "graphs_per_s", "p50_ms",
                                            "p99_ms")},
                      agree=pw["triangles"] == sweep["triangles"])
        log("tune_prewarm", **pw_row)
        out["prewarm"][name] = pw_row
        if (pw["plan_hit"] != 1.0 or pw["jit_compiles"] != 0
                or not pw_row["agree"]):
            raise SystemExit(f"tune {name}: prewarm replay {pw_row}")
        out[f"{name}_profile"] = path
        out[f"{name}_winner"] = sweep["winner_config"]
        out[f"{name}_triangles"] = sweep["triangles"]

    # (d) the first requests in fresh processes, cold and prewarmed
    first = real[:TUNE_FIRST]
    npz = tdir / "first.npz"
    np.savez(npz, k=len(first),
             **{f"e{i}": r.edges for i, r in enumerate(first)},
             **{f"n{i}": r.n_nodes for i, r in enumerate(first)})
    want = out["rmat12_16_64_triangles"][:TUNE_FIRST] * 2
    for tag, prof_path in (("cold", ""),
                           ("prewarmed", out["rmat12_16_64_profile"])):
        proc = subprocess.run(
            [sys.executable, "-c", TUNE_FRESH, str(ROOT / "src"), str(npz),
             prof_path], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"tune fresh {tag}: exit {proc.returncode}\n"
                             f"{proc.stdout}{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        k = len(first)
        lat = row["latency_s"]
        row.update(first_latency_s=lat[0], warm_latency_s=lat[k],
                   first_over_warm_s=lat[0] - lat[k],
                   median_latency_s=statistics.median(lat))
        log("tune_fresh", process=tag, **row)
        out["fresh"][tag] = row
        if row["triangles"] != want:
            raise SystemExit(f"tune fresh {tag}: {row['triangles']} != "
                             f"{want}")
    if any(out["fresh"]["prewarmed"]["jit_compiles"]):
        raise SystemExit(f"tune: the prewarmed process loaded a library "
                         f"after its prewarm: {out['fresh']['prewarmed']}")

    # (e) K1 at the winner's launch shapes: one more replay of (b)
    cfg = out["rmat12_16_64_winner"]
    eng = TriangleEngine(cfg.options, budgets=cfg.grid, device=dev)
    replay_trace(eng, real)  # plans built
    (res, _), calls = capture_counts(lambda: replay_trace(eng, real),
                                     "intersect_levels")
    got = sorted((r.request_id, r.triangles) for r in res)
    if [t for _, t in got] != out["rmat12_16_64_triangles"]:
        raise SystemExit("tune: the winner's captured replay differs")
    out["k1"] = time_tune_calls(calls)
    out["k1"]["winner"] = cfg.label
    log("tune_k1", **out["k1"])
    del calls, res
    torch.cuda.empty_cache()
    if out["k1"]["max_abs_err"]:
        raise SystemExit(f"tune: K1 at the winner's shapes differs from "
                         f"its plain version: {out['k1']}")
    tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    log("tune_summary", seconds=out["seconds"], device=card,
        sweeps={k: {**{f: v[f] for f in (
            "winner", "improvement_graphs_per_s", "p50_reduction",
            "evaluations", "seconds")},
            "turns_median_ratio": v["turns"]["median_ratio"]}
            for k, v in out["sweeps"].items()},
        prewarm=out["prewarm"],
        fresh={k: {f: v[f] for f in (
            "server_start_seconds", "first_latency_s", "warm_latency_s",
            "jit_compiles")} for k, v in out["fresh"].items()})
    return out


#: phase 12's profile: the reference's serving profile (read only), the
#: audit's default, carried across with ``profile_from_reference``
AUDIT_PROFILE = "results/tuned/serve_mix.json"
#: phase 12's server batch size (the compile set's census is at b8)
AUDIT_BATCH = 8
#: phase 12 (b)'s replay: the requests of the reference's mix (seed 0)
#: that the profile covers (cell and meta within its ceiling)
AUDIT_MIX = 96
#: phase 12 (c)'s local route: RMAT scale 16
AUDIT_LOCAL_SCALE = 16
#: the hot-path functions each route of phase 12 (c) runs, by the AST
#: findings' qualnames
_AUDIT_BATCH_FNS = (
    "TriangleEngine.plan_for", "TriangleEngine.count_batch_raw",
    "repro_torch.core.sequential._triangle_count_batch",
    "repro_torch.core.sequential.batch_plan_for",
    "repro_torch.core.bfs.bfs_levels_batch",
    "repro_torch.core.bfs.bfs_levels_iters",
    "repro_torch.core.intersect.run_plan",
)
AUDIT_ROUTE_FNS = {
    "batch": _AUDIT_BATCH_FNS,
    "local": ("repro_torch.core.sequential._exact_plan",
              "repro_torch.core.bfs.bfs_levels_iters",
              "repro_torch.core.intersect.run_plan"),
    "flush": ("TriangleServer.submit", "TriangleServer._pump_deadlines",
              "TriangleServer._flush", "TriangleServer._poll_inflight",
              "TriangleServer._finalize_one", "TriangleServer.drain",
              "TriangleEngine.pool_meta") + _AUDIT_BATCH_FNS,
}


def audit_phase(dev, main_path) -> dict:
    """Phase 12, the static auditor (module docstring): (a) the audit on
    the card's host diffed against the tracked baseline, (b) the compile
    set prewarmed on the card (a main path, K1 alone) and replayed, (c)
    the host syncs of three routes counted on the card.  Returns the
    phase's summary; exits on any failure."""
    from repro_torch.analysis.audit import (
        BASELINE,
        load_any_profile,
        run_audit,
    )
    from repro_torch.analysis.compile_set import plan_cache_keys
    from repro_torch.analysis.findings import Report, diff_reports
    from repro_torch.analysis.routes import enumerate_route_specs
    from repro_torch.analysis.walker import OpRecorder, op_counts, sync_ops
    from repro_torch.api import TriangleEngine
    from repro_torch.core.bfs import bfs_levels_iters
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import degree_meta, from_edges
    from repro_torch.launch.serve_tc import synth_requests

    t_phase = time.perf_counter()
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")
    out = {"syncs": {}}

    # (a) the audit runs its routes on the CPU by design: the report on
    # the card's host must be the tracked baseline's, key for key
    t0 = time.perf_counter()
    report = run_audit()
    audit_s = time.perf_counter() - t0
    base = Report.load(str(ROOT / BASELINE))
    diff = diff_reports(report, base)
    out["audit"] = dict(
        seconds=audit_s, findings=len(report.findings),
        counts=report.counts(),
        by_pass={k: len(v) for k, v in sorted(report.by_pass().items())},
        torch=report.meta["torch"], baseline_torch=base.meta.get("torch"),
        predicted_jit_compiles=report.meta["predicted_jit_compiles"],
        new=[f.site for f in diff.new], fixed=[f.site for f in diff.fixed])
    log("audit_diff", **out["audit"])
    if not diff.clean:
        raise SystemExit("audit: the report on the card's host differs from "
                         f"{BASELINE}\n{diff.render(BASELINE)}")
    census: dict = {}
    sweeps_cpu: dict = {}
    ast_sites: dict = {}
    for f in report.findings:
        if f.pass_name != "hostsync":
            continue
        if f.site.startswith("census:"):
            census.setdefault(f.data["route"], {})[f.data["op"]] = \
                f.data["count"]
            sweeps_cpu[f.data["route"]] = f.data["bfs_sweeps"]
        else:
            ast_sites.setdefault(f.data["qualname"], {})[f.data["attr"]] = \
                f.data["count"]

    # (b) the compile set on the card: a prewarmed server's plan cache
    # holds exactly the enumerated plan keys, K1 ran once a bucket of
    # every warm batch, and covered traffic hits and loads nothing
    eng = TriangleEngine(device=dev,
                         profile=load_any_profile(str(ROOT / AUDIT_PROFILE)))
    keys = eng.compile_space(batch_size=AUDIT_BATCH)
    want_keys = plan_cache_keys(eng)
    k1_want = sum(-(-b.rows // min(k.plan.query_chunk or b.rows, b.rows))
                  for k in keys for b in k.plan.buckets)
    srv, prewarm_s, _, launches, mem = main_path(
        lambda clock: eng.serve(batch_size=AUDIT_BATCH, prewarm=True))
    cached = eng._plan_cache.keys()
    cells = {c.budget: c.meta for c in eng.profile.cells
             if c.meta is not None}
    covered = []
    for e, n in synth_requests(AUDIT_MIX, seed=0):
        b = eng.budgets.budget_for(n, np.asarray(e).reshape(-1, 2).shape[0])
        if b in cells and cells[b].union(degree_meta(e, n)) == cells[b]:
            covered.append((b, e, n))
    t0 = time.perf_counter()
    for _, e, n in covered:
        srv.submit(e, n)
    got = {r.request_id: r.triangles for r in srv.drain()}
    replay_s = time.perf_counter() - t0
    s = srv.summary()
    cpu = TriangleEngine(device="cpu")
    want_tri = [cpu.count((e, n)).triangles for _, e, n in covered]
    out["prewarm"] = dict(
        profile=AUDIT_PROFILE, batch_size=AUDIT_BATCH,
        compile_keys=len(keys), plans=len({k.plan for k in keys}),
        plan_cache_entries=len(cached),
        want_plan_cache_entries=len(want_keys),
        prewarm_seconds=prewarm_s, launches=launches,
        k1_launches=launches["intersect_levels"], want_k1_launches=k1_want,
        memory=mem, replay_requests=len(covered), replay_seconds=replay_s,
        plan_hit=s["plan_hit"], jit_compiles=s["jit_compiles"],
        batches=s["batches"])
    log("audit_prewarm", **out["prewarm"])
    others = {k: v for k, v in launches.items()
              if k != "intersect_levels" and v}
    if (set(cached) != set(want_keys) or len(cached) != len(want_keys)
            or launches["intersect_levels"] != k1_want or others):
        raise SystemExit(f"audit: the prewarm is not the compile set: "
                         f"{out['prewarm']}")
    if (s["plan_hit"], s["jit_compiles"]) != (1.0, 0):
        raise SystemExit(f"audit: the covered replay missed a plan or "
                         f"loaded a library: {s}")
    if [got[i] for i in range(len(covered))] != want_tri:
        raise SystemExit("audit: the covered replay's answers differ from "
                         "the CPU's")

    # (c) the host syncs of three routes on the card: torch's sync debug
    # mode (``host_syncs``) and the op recorder's census of the same run,
    # beside the CPU census and the AST sites of the route's functions
    def card_syncs(tag, run, sweeps, cpu_census, cpu_sweeps, fns, **extra):
        run()  # warm: libraries loaded, allocator filled
        n_sync = host_syncs(run)
        with OpRecorder() as rec:
            res = run()
        ops = op_counts(sync_ops(rec.record))
        row = dict(route=tag, card_host_syncs=n_sync, card_census=ops,
                   card_census_total=sum(ops.values()),
                   card_bfs_sweeps=sweeps(res), cpu_census=cpu_census,
                   cpu_census_total=sum((cpu_census or {}).values()),
                   cpu_bfs_sweeps=cpu_sweeps,
                   ast={q: ast_sites[q] for q in fns if q in ast_sites},
                   device=card, **extra)
        log("audit_syncs", **row)
        out["syncs"][tag] = row
        return res

    spec = next(x for x in enumerate_route_specs(backends=("cuda",))
                if x.name == "batch/cuda")
    run, sweeps = spec.prepare(dev)
    ref = next(x for x in enumerate_route_specs()
               if x.name == "batch/torch").run("cpu")
    res = card_syncs("batch", run, sweeps, census.get("batch/torch"),
                     sweeps_cpu.get("batch/torch"), AUDIT_ROUTE_FNS["batch"],
                     graphs="karate + erdos_renyi(48, 0.1, seed=1), "
                            "budget 64 x 256, 2 lanes")
    for f in ("triangles", "c1", "c2", "num_horizontal"):
        if getattr(res, f).cpu().tolist() != getattr(ref, f).tolist():
            raise SystemExit(f"audit: the batch route's {f} on the card "
                             f"differs from the CPU's")
    e16, n16 = gen.rmat(AUDIT_LOCAL_SCALE, 16, seed=0)
    g16 = from_edges(e16, n16, device=dev)
    eng16 = TriangleEngine(device=dev)
    res = card_syncs(
        "local", lambda: eng16.count_raw(g16),
        lambda _: int(bfs_levels_iters(
            g16.src, g16.dst, g16.n_nodes, 0,
            row_offsets=g16.row_offsets)[1]),
        census.get("local/torch"), sweeps_cpu.get("local/torch"),
        AUDIT_ROUTE_FNS["local"],
        graphs=f"rmat{AUDIT_LOCAL_SCALE} (the CPU census: karate at the "
               f"pinned budget)")
    if (int(res.triangles), int(res.num_horizontal)) != EXPECTED[
            AUDIT_LOCAL_SCALE]:
        raise SystemExit("audit: the rmat16 count on the card is wrong")
    top = max(cells, key=lambda b: sum(1 for c, _, _ in covered if c == b))
    flush_reqs = [(e, n) for b, e, n in covered if b == top][:AUDIT_BATCH]

    def flush(engine):
        def run():
            server = engine.serve(batch_size=AUDIT_BATCH)
            for e, n in flush_reqs:
                server.submit(e, n)
            return server.drain()
        return run

    cpu_eng = TriangleEngine(device="cpu", profile=eng.profile)
    with OpRecorder() as rec:
        cpu_res = flush(cpu_eng)()
    res = card_syncs(
        "flush", flush(eng), lambda _: None, op_counts(sync_ops(rec.record)),
        None, AUDIT_ROUTE_FNS["flush"],
        graphs=f"{len(flush_reqs)} covered requests of cell "
               f"{top.n_budget}x{top.slot_budget}, one size flush")
    if ([r.triangles for r in res] != [r.triangles for r in cpu_res]
            or len(res) != len(flush_reqs)):
        raise SystemExit("audit: the prewarmed server's flush differs from "
                         "the CPU's")
    out["seconds"] = time.perf_counter() - t_phase
    log("audit_summary", seconds=out["seconds"], device=card,
        audit_seconds=audit_s, findings=out["audit"]["counts"],
        prewarm={k: out["prewarm"][k] for k in (
            "compile_keys", "plan_cache_entries", "prewarm_seconds",
            "k1_launches", "plan_hit", "jit_compiles")},
        syncs={k: {f: v[f] for f in (
            "card_host_syncs", "card_census_total", "cpu_census_total")}
            for k, v in out["syncs"].items()})
    return out


# ---------------------------------------------------------------- GNN zoo

#: phase 13 (a): ``segment_softmax``'s fixtures of the reference
#: (tests/test_segment_ops.py): (scores, ids, N); then an RMAT hub
SOFTMAX_FIXTURES = [
    ([1.0, 2.0, 3.0, 1.0], [0, 0, 1, 1], 2),
    ([float("-inf"), float("-inf"), 1.0, 2.0], [0, 0, 1, 1], 2),
    ([0.0, 0.0, 100.0], [0, 0, 5], 2),
]
#: phase 13 (a)'s hub: the destinations of rmat(14, 8) folded onto
#: 16,384 segments (the K4 sweep's "rmat" ids: a hub of 2,779 in-edges),
#: GAT's 8 heads
SOFTMAX_HUB = (131072, 16384, 8)
#: phase 13 (a): the card's softmax (its denominator on K4) against the
#: plain version in float64 on the CPU, |card - plain| <= tol * (1 +
#: |plain|) on every kept edge
SOFTMAX_TOL = 1e-5

#: phase 13 (b)-(e): (run, arch, ``launch/train.py`` arguments or None
#: for the sampled block, K4 launches a forward).  The shapes are the
#: registry's (configs/gnn.py:GNN_SHAPES): full_graph_sm (Cora),
#: minibatch_lg (a 1,024-seed block at fanouts 15 and 10) and molecule
#: (128 graphs of 30 atoms, at most 64 edges each)
ZOO_RUNS = [
    ("gat_cora", "gat-cora", ["--gnn-nodes", "2708", "--gnn-edges", "10556"],
     4),
    ("gat_minibatch_lg", "gat-cora", None, 4),
    ("schnet_molecule", "schnet", ["--gnn-nodes", "30", "--gnn-edges", "64",
                                   "--gnn-graphs", "128"], 4),
    ("dimenet_molecule", "dimenet", ["--gnn-nodes", "30", "--gnn-edges",
                                     "64", "--gnn-graphs", "128"], 8),
]
#: timed steps of each run after its warm-up and its main path
ZOO_TIMED = 20
#: phase 13 (c)'s base graph: Reddit's nodes, an RMAT topology of edge
#: factor 16 folded onto them as ``configs/data.py:gnn_batch`` folds one
ZOO_BASE_EF = 16


def zoo_softmax(dev) -> dict:
    """Phase 13 (a): ``segment_softmax`` on the card with its denominator
    on K4, launched twice (equal bits, one K4 launch a call), against
    its plain version in float64 on the CPU; exits on a failure."""
    from repro_torch.graph.segment import segment_softmax
    from repro_torch.kernels.segsum import ops as segops
    from repro_torch.kernels.segsum import segsum as k4

    cases = [(f"fixture{i}", torch.tensor(sc, dtype=torch.float32),
              torch.tensor(ids, dtype=torch.int32), n)
             for i, (sc, ids, n) in enumerate(SOFTMAX_FIXTURES)]
    e, n, h = SOFTMAX_HUB
    g = torch.Generator().manual_seed(0)
    cases.append(("rmat_hub", torch.randn((e, h), generator=g) * 3,
                  segsum_ids(None, e, n, "rmat", "cpu"), n))
    worst = 0.0
    for name, scores, ids, n in cases:
        s, i = scores.to(dev), ids.to(dev)
        lay = segops.build_layout(i, n)
        before = k4.LAUNCHES["segment_sum"]
        got = segment_softmax(s, i, n, layout=lay)
        again = segment_softmax(s, i, n, layout=lay)
        launched = k4.LAUNCHES["segment_sum"] - before
        want = segment_softmax(scores.double(), ids, n)
        keep = (ids >= 0) & (ids < n)
        diff = (got.cpu().double() - want).abs()[keep]
        ok = bool((diff <= SOFTMAX_TOL * (1 + want.abs()[keep])).all())
        err = float(diff.max()) if diff.numel() else 0.0
        same = bool(torch.equal(got, again))
        # a dropped row is the caller's to mask (fixture 2's is inf)
        finite = bool(torch.isfinite(got.cpu()[keep]).all())
        worst = max(worst, err)
        longest = int((lay.offsets[1:] - lay.offsets[:-1]).max().item())
        log("zoo_softmax", case=name, e=scores.shape[0], n=n,
            heads=scores.shape[1] if scores.dim() > 1 else 1,
            longest_segment=longest, k4_launches=launched,
            max_abs_err=err, tol=SOFTMAX_TOL, within_tol=ok,
            bit_identical=same, finite=finite)
        if not (ok and same and finite and launched == 2):
            raise SystemExit(f"segment_softmax {name}: error {err}, "
                             f"bit-identical {same}, finite {finite}, "
                             f"{launched} K4 launches (2 expected)")
    return {"max_abs_err": worst, "cases": len(SOFTMAX_FIXTURES) + 1}


def zoo_block(dev, cfg) -> tuple:
    """Phase 13 (c): the minibatch_lg base graph on the card (Reddit's
    232,965 nodes and 602 float32 features, an RMAT topology of edge
    factor 16 folded onto them), one block drawn by ``GNNSampledStream``
    on the card (checked bit for bit against the same draws on the
    CPU), as a ``GraphBatch``.  Returns ``(batch, data)``."""
    from repro_torch.configs.gnn import GNN_SHAPES
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import from_edges
    from repro_torch.train.data import GNNSampledStream, block_batch

    shape = GNN_SHAPES["minibatch_lg"]
    n, seeds, fan = shape["n_nodes"], shape["batch_nodes"], shape["fanout"]
    t0 = time.perf_counter()
    scale = int(np.ceil(np.log2(n)))
    edges, _ = gen.rmat(scale, ZOO_BASE_EF, seed=0)
    edges = edges % n
    edges = edges[edges[:, 0] != edges[:, 1]][:ZOO_BASE_EF * n]
    host_s = time.perf_counter() - t0
    g = from_edges(edges, n, num_slots=2 * ZOO_BASE_EF * n, device=dev)
    gen_d = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn((n, shape["d_feat"]), generator=gen_d, device=dev)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen_d,
                           device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stream = GNNSampledStream(g, seeds, fan, n, seed=0)
    next(stream)                                          # warm-up
    sample_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        block = next(stream)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t1) * 1e3)
    host_graph = SimpleNamespace(row_offsets=g.row_offsets.cpu(),
                                 dst=g.dst.cpu(), deg=g.deg.cpu())
    cpu_block = next(GNNSampledStream(host_graph, seeds, fan, n, seed=0,
                                      cursor=stream.cursor - 1))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(block, cpu_block))
    batch = block_batch(block, feat, labels)
    nodes = block[0]
    data = dict(base_nodes=n, base_undirected_edges_drawn=int(len(edges)),
                base_directed_edges=int(g.n_edges_dir.item()),
                base_max_degree=int(g.deg.max().item()),
                feature_bytes=feat.numel() * feat.element_size(),
                host_rmat_seconds=host_s, setup_seconds=setup_s,
                block_nodes=batch.n_nodes, block_slots=batch.n_edges,
                block_real_edges=int((block[2] < batch.n_nodes).sum().item()),
                block_distinct_nodes=int(torch.unique(
                    nodes[nodes < n]).numel()),
                sample_ms=sample_ms,
                median_sample_ms=statistics.median(sample_ms),
                block_equals_cpu=same)
    if not same:
        raise SystemExit("the sampled block on the card differs from the "
                         "CPU's for the same draws")
    want = (seeds * (1 + fan[0] + fan[0] * fan[1]),
            seeds * fan[0] + seeds * fan[0] * fan[1])
    if (batch.n_nodes, batch.n_edges) != want:
        raise SystemExit(f"block of {batch.n_nodes} nodes and "
                         f"{batch.n_edges} slots; expected {want}")
    del g, feat, labels, stream
    return batch, data


def gnn_zoo_phase(dev, main_path) -> dict:
    """Phase 13: the rest of the GNN family through K4 (see the module's
    docstring); ``main_path`` is ``main``'s.  Returns the phase's
    summary, with K4's sums over each run's recorded step."""
    import dataclasses

    from repro_torch.configs.gnn import GNN_SHAPES
    from repro_torch.configs.registry import GNN_FWD_FLOPS, arch_module
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.steps import GNN_MODULES, init_for
    from repro_torch.models.gnn.common import build_triplets
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    out = {"softmax": zoo_softmax(dev), "runs": {}, "k4": {}}
    for tag, arch, argv, want in ZOO_RUNS:
        t_run = time.perf_counter()
        cfg = arch_module(arch).CONFIG
        data = {}
        if argv is None:                  # (c) the sampled block
            cfg = dataclasses.replace(           # the registry's d_in
                cfg, d_in=GNN_SHAPES["minibatch_lg"]["d_feat"])
            batch, data = zoo_block(dev, cfg)
            loss_fn = GNN_MODULES[arch].loss_fn
            stream = ltrain.FixedStream(batch)
        else:
            args = ltrain.parse_args(["--arch", arch, *argv, "--steps",
                                      str(ZOO_TIMED + 4), "--device",
                                      "cuda"])
            loss_fn, stream = ltrain.build_gnn_pieces(arch, cfg, args)
            batch = stream.batch
        n, e = batch.n_nodes, batch.n_edges
        t = 0
        if batch.trip_kj is not None:     # (e) the triplet table, timed
            t = batch.trip_kj.shape[0]
            src, dst = batch.src.cpu().numpy(), batch.dst.cpu().numpy()
            t0 = time.perf_counter()
            kj, ji = build_triplets(src, dst, n, cap=t)
            data["build_triplets_seconds"] = time.perf_counter() - t0
            data["triplet_slots"] = t
            data["real_triplets"] = int((kj < e).sum())
            if not (np.array_equal(kj, batch.trip_kj.cpu().numpy())
                    and np.array_equal(ji, batch.trip_ji.cpu().numpy())):
                raise SystemExit(f"{tag}: the batch's triplets differ from "
                                 f"build_triplets'")
        torch.cuda.synchronize()
        real = batch.dst < n
        deg = torch.bincount(batch.dst[real].long(), minlength=n)
        data.update(nodes=n, slots=e, real_edges=int(real.sum().item()),
                    longest_segment=int(deg.max().item()),
                    setup_seconds=time.perf_counter() - t_run)
        log("zoo_data", run=tag, arch=arch, **data)
        model = init_for(arch, cfg, 0, dev)
        cpu = gnn_cpu_check(cfg, model, loss_fn, batch, dev, arch=arch,
                            run=tag, tag="zoo_cpu_vs_card")
        opt = OptConfig(kind="adamw", lr=3e-4, warmup=10,
                        total_steps=ZOO_TIMED + 4)
        trainer = Trainer(loss_fn, model, opt, cfg=cfg, log_every=10**9)
        first = trainer.fit(stream, 1)                        # warm-up
        rep, _, _, got, mem = main_path(lambda c: trainer.fit(stream, 1))
        if got["segment_sum"] != want or any(
                v for k, v in got.items() if k != "segment_sum"):
            raise SystemExit(f"{tag}: launched {got}; expected "
                             f"segment_sum alone, {want} times")
        timed_rep = trainer.fit(stream, ZOO_TIMED)
        steps_ms = [s * 1e3 for s in timed_rep["step_seconds"]]
        history = first["history"] + rep["history"] + timed_rep["history"]
        if not (np.isfinite(history).all() and history[-1] < history[0]):
            raise SystemExit(f"{tag}: the loss did not fall: {history}")
        med = statistics.median(steps_ms)
        busy_ms, wall_s, top, per = device_busy(
            lambda: trainer.fit(stream, 1))
        calls = []
        record_segsum(lambda: trainer.fit(stream, 1),
                      lambda m, lay, k: calls.append(time_segsum_call(
                          m, lay, k)))
        for i, c in enumerate(calls):
            log("zoo_k4_launch", run=tag, launch=i, **c)
        tot = sum_segsum_calls(calls)
        fwd = GNN_FWD_FLOPS[arch](cfg, n, e, *((t,) if t else ()))
        line = dict(
            run=tag, arch=arch, **data, launches=got, memory=mem,
            step_ms=steps_ms, median_step_ms=med,
            steps_per_second=1e3 / med, loss_first=history[0],
            loss_last=history[-1], steps=len(history),
            device_busy_ms=busy_ms, profiled_seconds=wall_s,
            busy_share=busy_ms / 1e3 / wall_s,
            busy_share_of_median_step=busy_ms / med,
            k4_device_ms=sum(ms for name, ms in per.items()
                             if "segsum" in name),
            top_device_ms=top, k4_step=tot,
            model_fwd_flops=fwd,
            model_step_flops=3 * fwd,          # the reference's 3 x forward
            model_step_tflops_per_s=3 * fwd / (med / 1e3) / 1e12,
            cpu_vs_card=cpu, seconds=time.perf_counter() - t_run)
        log("zoo_train", **line)
        if len(calls) != want or not (tot["within_tol"]
                                      and tot["bit_identical"]):
            raise SystemExit(f"{tag}: K4 on the recorded launches: "
                             f"{len(calls)} calls, {tot}")
        out["runs"][tag] = line
        out["k4"][tag] = tot
        del model, trainer, stream, batch, loss_fn, calls
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log("zoo_summary", softmax=out["softmax"], k4=out["k4"],
        seconds=out["seconds"])
    return out


# ------------------------------------------------------------- LM training

#: phase 14: smollm-135m trained at full width and depth, float32, AdamW,
#: seed 0.  ``batch`` x ``seq``: the repo's train_4k sequence, its global
#: batch of 256 cut to 4 for one card; ``check``: the short batch of the
#: first step held against the CPU; ``steps``: timed after one warm-up
#: and the main path's step
LM_TRAIN = {"arch": "smollm-135m", "batch": 4, "seq": 4096,
            "check": (1, 256), "steps": 20}

#: K5's backward against its plain version on the same CUDA tensors, and
#: each against float64: |kernel - want| <= tol * (1 + |want|).  float32:
#: sums of up to Hq / Hkv x S rows in other orders (the GNN gate); bf16:
#: the gradients rounded to bf16 (K5's forward tolerance)
K5_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

#: K5's backward: (b, hq, hkv, s, d, window, dtype), causal, S = T.
#: smollm-135m's training shape (the main path's), qwen2-moe-a2.7b's, a
#: gemma3-1b local layer (D 256, window 512, GQA 4:1), smollm's in bf16,
#: and two ragged ones in bf16 (S 1,000, a window of 300, GQA 2:1) at D 64
#: and 128, whose tiles end inside the tensor-core sub-tiles
K5_BWD_CASES = [
    (4, 9, 3, 4096, 64, None, torch.float32),
    (2, 16, 16, 4096, 128, None, torch.float32),
    (2, 4, 1, 4096, 256, 512, torch.float32),
    (4, 9, 3, 4096, 64, None, torch.bfloat16),
    (1, 4, 2, 1000, 64, 300, torch.bfloat16),
    (1, 4, 2, 1000, 128, 300, torch.bfloat16),
]

#: K5's backward's three launches, by the kernel names the profiler shows
K5_BWD_PASSES = ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")

#: phase 15: qwen2-moe-a2.7b at full width.  ``serve``: the server's
#: default request (batch, prompt, generated) at full depth; ``train``:
#: (layers, batch, seq, timed steps) -- the depth cut for AdamW's memory;
#: ``check``: the short batch of the first training step held against
#: the CPU
MOE = {"arch": "qwen2-moe-a2.7b", "serve": (4, 32, 16),
       "train": (2, 2, 4096, 10), "check": (1, 128)}


def attention_bwd_bound(q, k, kw):
    """K5's backward's least time for one call: ``(bound_ms, bound_by,
    bytes, flops)``, the larger of (a) q, k, v, o, dO and lse read and dq,
    dk, dv written once each over HBM's 3.35 TB/s and (b) its five S x T
    x D products (S, dP, dV, dS^T Q, dS K: 10 D operations) per live
    (row, key) pair over the card's peak rate for the operands' type:
    67 TFLOP/s for float32, the tensor cores' 989 for bf16."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    _, _, _, flops_fwd = attention_bound(q, k, kw)   # 4 D per live pair
    flops = flops_fwd // 4 * 10
    nbytes = (q.element_size() * (4 * b * hq * s * d + 4 * b * hkv * s * d)
              + 4 * b * hq * s)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = (BF16_FLOPS_PER_S if q.dtype == torch.bfloat16
            else FP32_FLOPS_PER_S)
    t_ops = flops / rate * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def k5_bwd_passes(run, ms: float) -> dict:
    """K5's backward's device milliseconds a launch by pass, from one
    profiled window of back-to-back ``run()`` calls (``ms`` each; ~30 ms
    of work, 3 to 400 calls): each pass's mean over the launches the
    profiler caught, and how many it caught of how many ran.  Late in
    this process a window loses ~57 kernel records (19 of each pass in a
    window of 21 calls or more, every one in a window of 4), so 256 empty
    launches pad the window on each side and are lost in their place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = max(3, min(400, int(30 / max(ms, 1e-3)) + 1))
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            pad.add_(0)
        for _ in range(reps):
            run()
        for _ in range(256):
            pad.add_(0)
        torch.cuda.synchronize()
    out = {"launched": reps}
    for p in K5_BWD_PASSES:
        t = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and p in e.name]
        out[p] = sum(t) / len(t) if t else None
        out[p + "_caught"] = len(t)
    return out


def sdpa_bwd_call(q, k, v, do, kw):
    """The yardstick: the backward of one ``scaled_dot_product_attention``
    call with the same boolean mask and GQA (never called by the port)."""
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    out = sdpa_call(qq, kk, vv, kw)()
    return lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                       retain_graph=True)


def k5_bwd_case(q, k, v, kw) -> dict:
    """K5's backward on one call's operands (random dO): its device and
    host-paced milliseconds, each pass's device milliseconds
    (``k5_bwd_passes``), equal bits across two launches, the plain version's
    milliseconds and both against it and against float64, the forward's
    log-sum-exp against the plain one, SDPA's backward and the bound; and
    K5's forward with the log-sum-exp at the same shape (device ms, bound,
    SDPA's forward).  These launches are comparisons, not the main
    path."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref,
        attention_ref,
    )

    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    _, lse_ref = attention_ref(q, k, v, return_lse=True, **kw)
    lse_err, lse_ok = within(lse, lse_ref, K5_TOL[torch.float32])
    same_out = bool(torch.equal(o, fa.flash_attention_fwd(q, k, v, **kw)[0]))
    do = torch.randn(o.shape, device=q.device).to(q.dtype)

    def run():
        return fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)

    got = run()
    same = all(torch.equal(a, b) for a, b in zip(got, run()))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = attention_bwd_ref(q, k, v, o, do, lse, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    tol = K5_BWD_TOL[q.dtype]
    errs = [within(a, b, tol) for a, b in zip(got, want)]
    plain = [within(b, a, tol)[0] for a, b in zip(got, want)]
    del want
    want64 = attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                               lse.double(), **kw)
    errs64 = [within(a, b, tol) for a, b in zip(got, want64)]
    del want64
    ms = device_ms(run, reps=3, spin=K5_SPIN * 4)
    host_ms = cuda_ms(run)
    pass_ms = k5_bwd_passes(run, ms)
    lib_ms = device_ms(sdpa_bwd_call(q, k, v, do, kw), reps=3,
                       spin=K5_SPIN * 4)
    bound, by, nbytes, flops = attention_bwd_bound(q, k, kw)
    del got, o, lse, do
    fwd_ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, with_lse=True,
                                                      **kw),
                       reps=3, spin=K5_SPIN * 2)
    fwd_bound, fwd_by, fwd_bytes, fwd_flops = attention_bound(q, k, kw)
    fwd_lib_ms = device_ms(sdpa_call(q, k, v, kw), reps=3, spin=K5_SPIN * 2)
    torch.cuda.empty_cache()
    return dict(
        ms=ms, host_paced_ms=host_ms, pass_ms=pass_ms, plain_ms=plain_ms,
        library_ms=lib_ms,
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
        fwd_ms=fwd_ms, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
        fwd_tensor_core_bound_ms=tensor_core_bound_ms(q, fwd_bytes,
                                                      fwd_flops),
        fwd_library_ms=fwd_lib_ms,
        max_abs_err=max(e for e, _ in errs),
        max_abs_err_float64=max(e for e, _ in errs64),
        within_tol=all(ok for _, ok in errs + errs64),
        max_abs_err_by_grad=dict(zip(("dq", "dk", "dv"),
                                     (e for e, _ in errs))),
        plain_max_abs_err=max(plain), tol=tol, bit_identical=same,
        lse_max_abs_err=lse_err, lse_within_tol=lse_ok,
        forward_bits_equal_without_lse=same_out)


def lm_step_flops(cfg, b: int, s: int) -> int:
    """A training step's model FLOPs: 3 x the forward's (the matmuls,
    2 per weight a token, the unembedding included; K5's 4 D per live
    causal pair a query head), the MoE layers at their active
    parameters; the remat recompute is not counted."""
    d, hq = cfg.d_model, cfg.n_heads * cfg.d_head
    hk = cfg.n_kv_heads * cfg.d_head
    ffn = (cfg.moe.active_param_count(d) if cfg.moe is not None
           else 3 * d * cfg.d_ff)
    per_layer = 2 * d * hq + 2 * d * hk + ffn
    pairs = b * cfg.n_heads * s * (s + 1) // 2
    fwd = (2 * b * s * (cfg.n_layers * per_layer + cfg.vocab * d)
           + cfg.n_layers * 4 * cfg.d_head * pairs)
    return 3 * fwd


def lm_cpu_check(arch, cfg, model, batch, tag: str) -> dict:
    """The first training step's loss and every gradient leaf on the card
    against the port's CPU plain path on the same weights (copied) and
    batch; raises past GNN_TOL.  The card's launches here are a
    comparison, not the main path; the gradients are cleared after."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import transformer as tfm

    with torch.device("cpu"):
        cpu_model = tfm.TransformerLM(cfg)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    tok, lab = batch
    t0 = time.perf_counter()
    cpu_loss = tfm.loss_fn(cpu_model, tok.cpu(), lab.cpu())
    cpu_loss.backward()
    cpu_s = time.perf_counter() - t0
    before = dict(fa.LAUNCHES)
    loss = tfm.loss_fn(model, tok, lab)
    loss.backward()
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    errs, ok = {}, True
    cpu_params = dict(cpu_model.named_parameters())
    for k, p in model.named_parameters():
        err, good = within(p.grad.cpu(), cpu_params[k].grad, GNN_TOL)
        errs[k] = err
        ok &= good
        p.grad = None
    loss_err, loss_ok = within(loss.detach().cpu(), cpu_loss.detach(),
                               GNN_TOL)
    worst = max(errs, key=errs.get)
    out = dict(batch=list(tok.shape), loss_card=loss.item(),
               loss_cpu=cpu_loss.item(), loss_abs_err=loss_err,
               grad_max_abs_err=errs[worst], grad_worst_param=worst,
               leaves=len(errs), tol=GNN_TOL, within_tol=bool(ok and loss_ok),
               k5_launches=launched, cpu_seconds=cpu_s)
    log(tag, arch=arch, **out)
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    if not out["within_tol"] or launched != want:
        raise SystemExit(f"{arch}: the card's first step differs from the "
                         f"CPU's or did not run K5's backward: {out}")
    del cpu_model
    return out


def train_run(tag, arch, cfg, model, stream, steps, main_path,
              want_launches, loss_fn=None):
    """A warm-up step, one step as a main path (``want_launches`` alone),
    ``steps`` timed steps (the loss falling), one profiled step (busy
    share, K5's and K4's device ms by kernel) of ``model`` through the
    trainer on ``stream``.  Returns ``(the run's line, the trainer)``."""
    from repro_torch.launch import steps as lsteps
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    b, s = stream.batch, stream.seq
    opt = OptConfig(kind="adamw", lr=3e-4, warmup=10, total_steps=steps + 4)
    trainer = Trainer(loss_fn or lsteps.lm_loss(cfg), model, opt, cfg=cfg,
                      log_every=10**9)
    first = trainer.fit(stream, 1)                              # warm-up
    rep, _, _, got, mem = main_path(lambda c: trainer.fit(stream, 1))
    if {k: v for k, v in got.items() if v} != want_launches:
        raise SystemExit(f"{tag}: launched {got}; expected "
                         f"{want_launches} alone")
    timed = trainer.fit(stream, steps)
    steps_ms = [x * 1e3 for x in timed["step_seconds"]]
    history = first["history"] + rep["history"] + timed["history"]
    if not (np.isfinite(history).all() and history[-1] < history[0]):
        raise SystemExit(f"{tag}: the loss did not fall: {history}")
    med = statistics.median(steps_ms)
    busy_ms, wall_s, top, per = device_busy(lambda: trainer.fit(stream, 1))
    flops = lm_step_flops(cfg, b, s)
    line = dict(
        run=tag, arch=arch, layers=cfg.n_layers, batch=b, seq=s,
        params=sum(p.numel() for p in model.parameters()),
        launches_per_step=got, memory=mem, step_ms=steps_ms,
        median_step_ms=med, tokens_per_second=b * s / (med / 1e3),
        loss=history, loss_first=history[0], loss_last=history[-1],
        device_busy_ms=busy_ms, profiled_seconds=wall_s,
        busy_share=busy_ms / 1e3 / wall_s,
        k5_fwd_device_ms=sum(ms for n, ms in per.items()
                             if "attn_prefill" in n),
        k5_bwd_device_ms=sum(ms for n, ms in per.items() if "attn_bwd" in n),
        k5_bwd_pass_device_ms={p: sum(ms for n, ms in per.items() if p in n)
                               for p in K5_BWD_PASSES},
        k4_device_ms=sum(ms for n, ms in per.items() if "segsum" in n),
        top_device_ms=top, model_step_flops=flops,
        model_tflops_per_s=flops / (med / 1e3) / 1e12)
    return line, trainer


def lm_train_phase(dev, main_path) -> dict:
    """Phase 14: smollm-135m trained at full width and depth, every
    attention's forward and backward through K5 (see the module's
    docstring); ``main_path`` is ``main``'s.  Returns the phase's summary
    and the K5 backward's entry of the ``kernels`` line."""
    from repro_torch.configs.data import lm_batch
    from repro_torch.configs.registry import arch_module
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.steps import init_for

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"cases": []}
    # 14a. K5's backward against its plain version and float64
    for b, hq, hkv, s, d, window, dt in K5_BWD_CASES:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d)))
        kw = dict(causal=True, window=window, kv_offset=0)
        c = dict(b=b, hq=hq, hkv=hkv, s=s, d=d, window=window,
                 dtype=str(dt), **k5_bwd_case(q, k, v, kw))
        log("k5_bwd_vs_plain", **c)
        out["cases"].append(c)
        if not (c["within_tol"] and c["bit_identical"]
                and c["lse_within_tol"]
                and c["forward_bits_equal_without_lse"]):
            raise SystemExit(f"K5's backward at {(b, hq, hkv, s, d)}, "
                             f"window {window}, {dt}: {c}")
        del q, k, v
    torch.cuda.empty_cache()

    # 14b. the first step on the card against the CPU, full width and
    # depth, a short batch
    arch = LM_TRAIN["arch"]
    cfg = arch_module(arch).CONFIG
    model = init_for(arch, cfg, 0, dev)
    out["init_seconds"] = model.init_seconds
    cb, cs = LM_TRAIN["check"]
    out["cpu_vs_card"] = lm_cpu_check(
        arch, cfg, model, lm_batch(cfg, cb, cs, 0, device=dev),
        "lm_train_cpu_vs_card")

    # 14c. the timed steps at B x S through launch/train.py's pieces
    b, s, steps = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["steps"]
    args = ltrain.parse_args(["--arch", arch, "--batch", str(b), "--seq",
                              str(s), "--steps", str(steps + 4)])
    loss_fn, stream = ltrain.build_lm_pieces(cfg, args)
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    line, trainer = train_run("smollm-135m", arch, cfg, model, stream,
                              steps, main_path, want, loss_fn)
    log("lm_train", **line)
    out["run"] = line
    del model, trainer, stream
    torch.cuda.empty_cache()
    main = out["cases"][0]
    out["kernel"] = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "none: the reference differentiates "
                    "src/repro/models/transformer.py:143 (_attend) under "
                    "XLA; its Pallas K5 has no backward",
        "launches": line["launches_per_step"]["flash_attention_bwd"],
        "matches_plain": all(c["within_tol"] for c in out["cases"]),
        "bit_identical": all(c["bit_identical"] for c in out["cases"]),
        "max_abs_err": max(c["max_abs_err"] for c in out["cases"]
                           if c["dtype"] == str(torch.float32)),
        "max_abs_err_bf16": max(c["max_abs_err"] for c in out["cases"]
                                if c["dtype"] == str(torch.bfloat16)),
        **{key: main[key] for key in (
            "ms", "host_paced_ms", "pass_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err_float64")},
        "step_device_ms": line["k5_bwd_device_ms"],
        "cases": {f"{c['b']}x{c['hq']}/{c['hkv']}x{c['s']}x{c['d']}"
                  f"{'w' + str(c['window']) if c['window'] else ''}"
                  f"{'-bf16' if 'bfloat16' in c['dtype'] else ''}": {
                      key: c[key] for key in (
                          "ms", "host_paced_ms", "pass_ms", "plain_ms",
                          "library_ms", "bound_ms", "bound_by", "max_abs_err",
                          "max_abs_err_float64", "fwd_ms", "fwd_bound_ms",
                          "fwd_tensor_core_bound_ms", "fwd_library_ms")}
                  for c in out["cases"]},
        "shape": "per launch at smollm-135m's training shape (B 4, Hq 9, "
                 "Hkv 3, S = T 4,096, D 64, causal, float32), the shape of "
                 "each of the main path's launches (launches: one training "
                 "step's, 30 at 30 layers; step_device_ms: their profiled "
                 "sum; pass_ms: each pass's device ms a launch, the mean "
                 "over the launches one profiled window caught); cases: "
                 "qwen2-moe's (B 2, 16 heads, D 128), a gemma3-1b local "
                 "layer (D 256, window 512, GQA 4:1), smollm's in bf16 and "
                 "two ragged bf16 ones (S 1,000, "
                 "window 300, GQA 2:1, D 64 and 128), each also with K5's "
                 "forward with the log-sum-exp at its shape (fwd_*: device "
                 "ms, the FMA and tensor-core bounds, SDPA's forward); "
                 "library: the backward of SDPA with enable_gqa and the "
                 "same boolean mask",
    }
    out["seconds"] = time.perf_counter() - t_phase
    log("lm_train_summary", **{k: v for k, v in out.items()
                               if k not in ("run", "cases")})
    return out


def route_calls(run) -> list:
    """``run()`` with every call of ``models/moe.py:route`` recorded, in
    order: ``(tokens, capacity, routing)``."""
    from repro_torch.models import moe as tmoe

    real, seen = tmoe.route, []

    def spy(router, cfg, tokens, capacity):
        r = real(router, cfg, tokens, capacity)
        seen.append((tokens.shape[0], capacity, r))
        return r

    tmoe.route = spy
    try:
        run()
    finally:
        tmoe.route = real
    return seen


def moe_drops(run) -> dict:
    """``run()`` with each MoE layer's routing recorded: the dropped
    fraction of the (token, expert) entries of every call, by its token
    count."""
    seen = {}
    for n, capacity, r in route_calls(run):
        seen.setdefault(n, []).append(
            (int(r.keep.numel()), int((~r.keep).sum().item()), capacity))
    return {n: dict(calls=len(v), capacity=v[0][2],
                    dropped=sum(x[1] for x in v),
                    entries=sum(x[0] for x in v),
                    drop_fraction=sum(x[1] for x in v) / sum(x[0] for x in v))
            for n, v in seen.items()}


def leaves_on_cpu(leaves: dict) -> dict:
    """A copy of a MoE layer's ``leaves()`` on the CPU."""
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                else {n: t.detach().cpu() for n, t in v.items()})
            for k, v in leaves.items()}


def moe_layer_check(model, cfg, dev) -> dict:
    """Layer 0's MoE FFN at full width on the card against the CPU, on the
    same weights (copied) and a random [4, 32, d_model] input: the
    routing integers equal, the output and aux loss within GNN_TOL."""
    from repro_torch.models import moe as tmoe

    leaves = model.layers[0].moe.leaves()
    cpu_leaves = leaves_on_cpu(leaves)
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    with torch.no_grad():
        got, aux = tmoe.moe_ffn(leaves, cfg.moe, x)
        want, aux_cpu = tmoe.moe_ffn(cpu_leaves, cfg.moe, x.cpu())
        n = x.shape[0] * x.shape[1]
        cap = tmoe.capacity_for(cfg.moe, n)
        r = tmoe.route(leaves["router"], cfg.moe, x.reshape(n, -1), cap)
        rc = tmoe.route(cpu_leaves["router"], cfg.moe,
                        x.cpu().reshape(n, -1), cap)
    top = rc.probs.sort(-1, descending=True).values
    k = cfg.moe.top_k
    same = {f: bool(torch.equal(getattr(r, f).cpu(), getattr(rc, f)))
            for f in ("expert_idx", "se", "stok", "pos", "keep")}
    err, ok = within(got.cpu(), want, GNN_TOL)
    aux_err, aux_ok = within(aux.cpu(), aux_cpu, GNN_TOL)
    out = dict(tokens=n, capacity=cap, max_abs_err=err, aux_abs_err=aux_err,
               tol=GNN_TOL, within_tol=bool(ok and aux_ok),
               routing_equal=same,
               smallest_topk_gap=float((top[:, k - 1] - top[:, k]).min()),
               dropped=int((~rc.keep).sum()))
    log("moe_layer_cpu_vs_card", **out)
    if not (out["within_tol"] and all(same.values())):
        raise SystemExit(f"the MoE layer on the card differs from the "
                         f"CPU's: {out}")
    return out


def moe_phase(dev, main_path) -> dict:
    """Phase 15: qwen2-moe-a2.7b at full width, served at full depth and
    trained at 2 layers, every expert combine on K4 (see the module's
    docstring); ``main_path`` is ``main``'s.  Returns the phase's summary
    with K4's MoE entries."""
    import dataclasses

    from repro_torch.configs.data import lm_batch
    from repro_torch.configs.registry import arch_module
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.serve import prompt_tokens, serve
    from repro_torch.launch.steps import init_for
    from repro_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    arch = MOE["arch"]
    cfg = arch_module(arch).CONFIG
    out = {"k4": {}}
    # 15a. serving at full depth through launch/serve.py's path
    model = init_for(arch, cfg, 0, dev)
    torch.cuda.synchronize()
    out["draw_seconds"] = model.init_seconds
    out["params"] = sum(p.numel() for p in model.parameters())
    out["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    b, p, gen = MOE["serve"]
    tokens = prompt_tokens(cfg, b, p, dev)
    serve(model, tokens, gen)                                   # warm-up
    first, _, _, got, mem = main_path(lambda c: serve(model, tokens, gen))
    want = {"flash_attention": cfg.n_layers * gen,
            "segment_sum": cfg.n_layers * gen}
    if {k: v for k, v in got.items() if v} != want:
        raise SystemExit(f"{arch} serve: launched {got}; expected {want}")
    runs = [first] + [serve(model, tokens, gen) for _ in range(2)]
    same_ids = all(torch.equal(r.ids, first.ids) for r in runs)
    finite = all(bool(torch.isfinite(r.logits).all()) for r in runs)
    drops = moe_drops(lambda: serve(model, tokens, gen))
    busy_ms, wall_s, top, per = device_busy(lambda: serve(model, tokens,
                                                          gen))
    steps = gen - 1
    line = dict(
        arch=arch, layers=cfg.n_layers, batch=b, prompt=p, generated=gen,
        launches=got, launches_per_token={
            k: v / (b * gen) for k, v in got.items() if v},
        launches_per_step={k: v / gen for k, v in got.items() if v},
        memory=mem, prefill_ms=[r.prefill_s * 1e3 for r in runs],
        median_prefill_ms=statistics.median(r.prefill_s
                                            for r in runs) * 1e3,
        median_decode_ms_per_step=statistics.median(
            r.decode_s for r in runs) / steps * 1e3,
        decode_tokens_per_second=statistics.median(
            b * steps / r.decode_s for r in runs),
        drop_fraction={"prefill": drops[b * p]["drop_fraction"],
                       "decode": drops[b]["drop_fraction"]},
        drops=drops, ids_equal_across_runs=same_ids, finite=finite,
        device_busy_ms=busy_ms, profiled_seconds=wall_s,
        busy_share=busy_ms / 1e3 / wall_s,
        k4_device_ms=sum(ms for n, ms in per.items() if "segsum" in n),
        k5_device_ms=sum(ms for n, ms in per.items() if "attn_" in n),
        top_device_ms=top, ids0=first.ids[0].tolist())
    log("moe_serve", **line)
    if not (same_ids and finite):
        raise SystemExit(f"{arch} serve: ids differ across runs or logits "
                         f"are not finite")
    out["serve"] = line
    out["layer_check"] = moe_layer_check(model, cfg, dev)
    # K4 at the serving shapes: every launch of a prefill and one decode
    # step, each timed and held against its plain version
    calls = []
    record_segsum(lambda: serve(model, tokens, 2),
                  lambda m, lay, k: calls.append(time_segsum_call(m, lay,
                                                                  k)))
    for tag, rows in (("prefill", b * p * cfg.moe.top_k),
                      ("decode", b * cfg.moe.top_k)):
        mine = [c for c in calls if c["e"] == rows]
        out["k4"][tag] = sum_segsum_calls(mine)
        out["k4"][tag].update(e=rows, f=cfg.d_model)
        log("moe_k4", part=tag, **out["k4"][tag])
    del model, tokens, first, runs
    torch.cuda.empty_cache()

    # 15b. training at 2 layers: the first step against the CPU, then the
    # timed steps at B x S through launch/train.py's pieces
    layers, tb, ts, tsteps = MOE["train"]
    cfg2 = dataclasses.replace(cfg, n_layers=layers)
    model = init_for(arch, cfg2, 0, dev)
    out["train_draw_seconds"] = model.init_seconds
    cb, cs = MOE["check"]
    out["cpu_vs_card"] = lm_cpu_check(
        arch, cfg2, model, lm_batch(cfg2, cb, cs, 0, device=dev),
        "moe_train_cpu_vs_card")
    args = ltrain.parse_args(["--arch", arch, "--batch", str(tb), "--seq",
                              str(ts), "--steps", str(tsteps + 4)])
    _, stream = ltrain.build_lm_pieces(cfg2, args)
    auxes = []

    def loss_fn(m, tok, lab):   # the reference's loss, its aux kept
        logits, aux = m(tok)
        auxes.append(aux.detach())
        return tfm.softmax_xent(logits, lab) + 0.01 * aux

    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "segment_sum": 2 * layers}
    line, trainer = train_run(f"{arch}-{layers}-layers", arch, cfg2, model,
                              stream, tsteps, main_path, want, loss_fn)
    line["aux_loss"] = [float(a) for a in auxes]
    log("moe_train", **line)
    out["train"] = line
    calls = []
    record_segsum(lambda: trainer.fit(stream, 1),
                  lambda m, lay, k: calls.append(time_segsum_call(m, lay,
                                                                  k)))
    out["k4"]["train"] = sum_segsum_calls(calls)
    out["k4"]["train"].update(e=tb * ts * cfg.moe.top_k, f=cfg.d_model)
    log("moe_k4", part="train", **out["k4"]["train"])
    bad = [t for t, v in out["k4"].items()
           if not (v["within_tol"] and v["bit_identical"] and v["launches"])]
    if bad:
        raise SystemExit(f"K4 at the MoE shapes: {bad}: {out['k4']}")
    del model, trainer, stream
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log("moe_summary", **{k: v for k, v in out.items()
                          if k not in ("serve", "train")})
    return out



# -------------------------------------------------------------------- BST

#: phase 16: the card against the port's CPU path on the same weights
#: (logits, loss, every gradient leaf, one AdamW step, served logits,
#: retrieval scores), |card - cpu| <= tol * (1 + |cpu|): float32 matmuls,
#: softmax and LayerNorm in other orders, and atomics in the tables'
#: gradients (``index_add_``)
BST_TOL = 1e-4
#: phase 16 (b): timed training steps after a warm-up and the main path
BST_TIMED = 20
#: phase 16 (c): timed serves of each size
BST_SERVES = 5
#: phase 16 (d): the retrieval's first scores held against the CPU's
BST_CHECK_SCORES = 4096
#: phase 16 (d): timed retrievals after a warm-up and the main path
BST_RETRIEVALS = 3


def bst_cpu_check(cfg, model, cpu_model, dev) -> dict:
    """Phase 16 (a): at ``serve_p99``'s batch of 512 (``bst_batch`` seed
    0, drawn on the CPU), the card's logits, loss, every gradient leaf
    and the weights after one AdamW step through ``bst_train_step``
    against the port's CPU path on the same weights (``cpu_model``, a
    copy); raises past BST_TOL.  The card's launches here are a
    comparison, not the main path; both models get their weights back
    after."""
    from repro_torch.configs.data import bst_batch
    from repro_torch.configs.recsys import RECSYS_SHAPES
    from repro_torch.kernels.segsum import segsum as k4
    from repro_torch.launch.steps import bst_train_step
    from repro_torch.models.recsys.bst import loss_fn
    from repro_torch.train.optimizer import OptConfig, opt_init

    b = RECSYS_SHAPES["serve_p99"]["batch"]
    batch = bst_batch(cfg, b, 0, device="cpu")
    card_batch = tuple(t.to(dev) for t in batch)
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        cpu_logits = cpu_model(*batch[:4])
        card_logits = model(*card_batch[:4])
    logit_err, logit_ok = within(card_logits.cpu(), cpu_logits, BST_TOL)
    t0 = time.perf_counter()
    cpu_loss = loss_fn(cpu_model, *batch)
    cpu_loss.backward()
    cpu_s = time.perf_counter() - t0
    before = k4.LAUNCHES["segment_sum"]
    loss = loss_fn(model, *card_batch)
    loss.backward()
    torch.cuda.synchronize()
    launched = k4.LAUNCHES["segment_sum"] - before
    cpu_params = dict(cpu_model.named_parameters())
    grad_errs, ok = {}, logit_ok
    for k, p in model.named_parameters():
        grad_errs[k], good = within(p.grad.cpu(), cpu_params[k].grad, BST_TOL)
        ok &= good
        p.grad = None
        cpu_params[k].grad = None
    loss_err, loss_ok = within(loss.detach().cpu(), cpu_loss.detach(),
                               BST_TOL)
    opt = OptConfig(kind="adamw", lr=3e-4, warmup=10,
                    total_steps=BST_TIMED + 4)
    step = bst_train_step(cfg, opt)
    _, cpu_m = step(cpu_model, opt_init(opt, cpu_params), *batch)
    _, card_m = step(model, opt_init(opt, dict(model.named_parameters())),
                     *card_batch)
    step_errs = {}
    for k, p in model.named_parameters():
        step_errs[k], good = within(p.detach().cpu(), cpu_params[k].detach(),
                                    BST_TOL)
        ok &= good
    moved = max(float((cpu_params[k].detach() - saved[k].cpu()).abs().max())
                for k in cpu_params)
    with torch.no_grad():
        for k, p in model.state_dict().items():
            p.copy_(saved[k])
        for k, p in cpu_model.state_dict().items():
            p.copy_(saved[k].cpu())
    for m in (model, cpu_model):
        for p in m.parameters():
            p.grad = None
    tables = ("item_embed", "profile_embed")
    dense = {k: v for k, v in grad_errs.items() if k not in tables}
    out = dict(
        batch=b, logits_max_abs_err=logit_err, loss_card=loss.item(),
        loss_cpu=cpu_loss.item(), loss_abs_err=loss_err,
        dense_grad_max_abs_err=max(dense.values()),
        dense_grad_worst_leaf=max(dense, key=dense.get),
        table_grad_max_abs_err={k: grad_errs[k] for k in tables},
        adamw_step_max_abs_err=max(step_errs.values()),
        adamw_step_worst_leaf=max(step_errs, key=step_errs.get),
        adamw_step_moved=moved, adamw_loss=[float(card_m["loss"]),
                                            float(cpu_m["loss"])],
        leaves=len(grad_errs), tol=BST_TOL, k4_launches=launched,
        within_tol=bool(ok and loss_ok), cpu_seconds=cpu_s)
    log("bst_cpu_vs_card", **out)
    if not out["within_tol"] or launched != 1 or moved <= 0:
        raise SystemExit(f"bst: the card's first step differs from the "
                         f"CPU's or did not run K4: {out}")
    return out


def bst_serve_runs(cfg, model, cpu_model, dev, main_path) -> dict:
    """Phase 16 (c): ``bst_serve_step`` at ``serve_p99`` and
    ``serve_bulk``: a warm-up, one serve as a main path (K4 alone, once),
    BST_SERVES timed serves (each synchronised), the first
    BST_CHECK_SCORES rows against the CPU's."""
    from repro_torch.configs.data import bst_batch
    from repro_torch.configs.recsys import RECSYS_SHAPES
    from repro_torch.launch.steps import bst_serve_step

    serve = bst_serve_step(cfg)
    out = {}
    for tag in ("serve_p99", "serve_bulk"):
        b = RECSYS_SHAPES[tag]["batch"]
        batch = bst_batch(cfg, b, 1, device=dev)

        def run(_clock=None, batch=batch):
            y = serve(model, *batch[:4])
            torch.cuda.synchronize()
            return y

        run()
        first, _, _, got, mem = main_path(run)
        if {k: v for k, v in got.items() if v} != {"segment_sum": 1}:
            raise SystemExit(f"bst {tag}: launched {got}; expected "
                             f"segment_sum alone, once")
        ms, same = [], True
        for _ in range(BST_SERVES):
            t0 = time.perf_counter()
            y = run()
            ms.append((time.perf_counter() - t0) * 1e3)
            same &= bool(torch.equal(y, first))
        k = min(b, BST_CHECK_SCORES)
        hist, target, pidx, pbag = (batch[0][:k], batch[1][:k],
                                    batch[2][:k * cfg.profile_bag],
                                    batch[3][:k * cfg.profile_bag])
        with torch.no_grad():
            want = cpu_model(hist.cpu(), target.cpu(), pidx.cpu(),
                             pbag.cpu())
        err, ok = within(first[:k].cpu(), want, BST_TOL)
        med = statistics.median(ms)
        line = dict(shape=tag, batch=b, launches=got, memory=mem, ms=ms,
                    median_ms=med, samples_per_second=b / (med / 1e3),
                    bit_identical_across_serves=same,
                    checked_rows=k, max_abs_err=err, tol=BST_TOL,
                    within_tol=ok,
                    finite=bool(torch.isfinite(first).all()))
        log("bst_serve", **line)
        if not (ok and line["finite"] and first.shape == (b,)):
            raise SystemExit(f"bst {tag}: {line}")
        out[tag] = line
        del batch, first, y
    return out


def bst_retrieval_run(cfg, model, cpu_model, dev, main_path) -> dict:
    """Phase 16 (d): ``bst_retrieval_step`` over ``retrieval_cand``'s
    10^6 candidates in slices of ``bst.RETRIEVAL_SLICE``: a warm-up, one
    run as a main path (no kernel of the port: the profile vector is
    zero, so no bag sum), BST_RETRIEVALS timed runs; every score finite,
    the first BST_CHECK_SCORES against the CPU's one-shot call."""
    from repro_torch.configs.recsys import RECSYS_SHAPES
    from repro_torch.launch.steps import bst_retrieval_step
    from repro_torch.models.recsys.bst import RETRIEVAL_SLICE

    c = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    gen = torch.Generator().manual_seed(2)
    cands = torch.randint(0, cfg.item_vocab, (c,), generator=gen)
    hist = torch.randint(0, cfg.item_vocab, (cfg.seq_len - 1,),
                         generator=gen)
    cands_d, hist_d = cands.to(dev), hist.to(dev)
    retrieve = bst_retrieval_step(cfg)

    def run(_clock=None):
        y = retrieve(model, hist_d, cands_d)
        torch.cuda.synchronize()
        return y

    run()
    first, secs, _, got, mem = main_path(run)
    if any(got.values()):
        raise SystemExit(f"bst retrieval: launched {got}; its path has no "
                         f"kernel of the port")
    times, same = [], True
    for _ in range(BST_RETRIEVALS):
        t0 = time.perf_counter()
        y = run()
        times.append(time.perf_counter() - t0)
        same &= bool(torch.equal(y, first))
    k = BST_CHECK_SCORES
    with torch.no_grad():
        want = cpu_model.score_candidates(hist, cands[:k])
    err, ok = within(first[:k].cpu(), want, BST_TOL)
    med = statistics.median(times)
    line = dict(candidates=c, chunk=RETRIEVAL_SLICE, launches=got, memory=mem,
                main_path_seconds=secs, seconds=times,
                median_seconds=med, candidates_per_second=c / med,
                bit_identical_across_runs=same, checked_scores=k,
                max_abs_err=err, tol=BST_TOL, within_tol=ok,
                finite=bool(torch.isfinite(first).all()))
    log("bst_retrieval", **line)
    if not (ok and line["finite"] and first.shape == (c,)):
        raise SystemExit(f"bst retrieval: {line}")
    return line


def bst_k4_shape(cfg, model, dev) -> dict:
    """Phase 16 (e): the whole bag function at the training shape (524,288
    lookups into 65,536 bags, F 32) on a fresh batch: the port's
    ``embedding_bag`` (the gather, the layout, K4) against
    ``F.embedding_bag(mode="sum")``, the library call for the whole
    function, each timed on the device and held against the float64 sum;
    the port's twice, equal bit for bit."""
    import torch.nn.functional as F

    from repro_torch.configs.data import bst_batch
    from repro_torch.configs.recsys import RECSYS_SHAPES
    from repro_torch.graph.segment import embedding_bag

    b = RECSYS_SHAPES["train_batch"]["batch"]
    _, _, pidx, pbag, _ = bst_batch(cfg, b, 3, device=dev)
    table = model.profile_embed.detach()
    offsets = torch.arange(b, device=dev) * cfg.profile_bag
    with torch.no_grad():
        ms = device_ms(lambda: embedding_bag(table, pidx, pbag, b))
        lib_ms = device_ms(lambda: F.embedding_bag(pidx, table, offsets,
                                                   mode="sum"))
        got = embedding_bag(table, pidx, pbag, b)
        same = bool(torch.equal(got, embedding_bag(table, pidx, pbag, b)))
        rows = table.index_select(0, pidx)
        err, scaled, ok = k4_within(got, rows, pbag, b, K4_TOL[torch.float32])
        lib_err, lib_scaled, _ = k4_within(
            F.embedding_bag(pidx, table, offsets, mode="sum"), rows, pbag, b,
            K4_TOL[torch.float32])
    # the gather reads each looked-up row once and the bag sum writes each
    # bag once; the indices and bag ids are read once
    nbytes = (pidx.numel() * (cfg.embed_dim * 4 + 8 + 8)
              + b * cfg.embed_dim * 4)
    line = dict(lookups=pidx.numel(), bags=b, f=cfg.embed_dim,
                embedding_bag_ms=ms, f_embedding_bag_ms=lib_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=nbytes, max_abs_err=err, max_scaled_err=scaled,
                within_tol=ok, bit_identical=same,
                library_max_abs_err=lib_err,
                library_max_scaled_err=lib_scaled)
    log("bst_embedding_bag", **line)
    if not (ok and same):
        raise SystemExit(f"bst embedding_bag: {line}")
    return line


def bst_phase(dev, main_path) -> dict:
    """Phase 16: the recsys BST at full width (see the module's
    docstring); ``main_path`` is ``main``'s.  Returns the phase's summary,
    with K4's sums at BST's shape."""
    import dataclasses

    from repro_torch.api import TriangleEngine
    from repro_torch.configs.recsys import RECSYS_SHAPES
    from repro_torch.configs.registry import arch_module
    from repro_torch.core.shards import LocalShards
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.steps import init_for
    from repro_torch.models.recsys.bst import BST
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = arch_module("bst").CONFIG
    model = init_for("bst", cfg, 0, dev)
    with torch.device("cpu"):
        cpu_model = BST(cfg)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    out = {"init_seconds": model.init_seconds,
           "params": sum(p.numel() for p in model.parameters()),
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
    log("bst_setup", config=dataclasses.asdict(cfg), shapes=RECSYS_SHAPES,
        **out)
    out["cpu_vs_card"] = bst_cpu_check(cfg, model, cpu_model, dev)
    out["serve"] = bst_serve_runs(cfg, model, cpu_model, dev, main_path)
    out["retrieval"] = bst_retrieval_run(cfg, model, cpu_model, dev,
                                         main_path)
    del cpu_model

    # (b) training at train_batch through launch/train.py's pieces
    t_run = time.perf_counter()
    b = RECSYS_SHAPES["train_batch"]["batch"]
    args = ltrain.parse_args(["--arch", "bst", "--batch", str(b), "--steps",
                              str(BST_TIMED + 4), "--device", str(dev)])
    loss_fn, stream = ltrain.build_bst_pieces(cfg, args)
    opt = OptConfig(kind="adamw", lr=3e-4, warmup=10,
                    total_steps=BST_TIMED + 4)
    trainer = Trainer(loss_fn, model, opt, cfg=cfg, log_every=10**9)
    first = trainer.fit(stream, 1)                              # warm-up
    rep, _, _, got, mem = main_path(lambda c: trainer.fit(stream, 1))
    if {k: v for k, v in got.items() if v} != {"segment_sum": 1}:
        raise SystemExit(f"bst train: launched {got}; expected segment_sum "
                         f"alone, once a step")
    timed = trainer.fit(stream, BST_TIMED)
    steps_ms = [x * 1e3 for x in timed["step_seconds"]]
    history = first["history"] + rep["history"] + timed["history"]
    if not (np.isfinite(history).all() and history[-1] < history[0]):
        raise SystemExit(f"bst train: the loss did not fall: {history}")
    med = statistics.median(steps_ms)
    busy_ms, wall_s, top, per = device_busy(lambda: trainer.fit(stream, 1))
    calls = []
    record_segsum(lambda: trainer.fit(stream, 1),
                  lambda m, lay, k: calls.append(time_segsum_call(m, lay,
                                                                  k)))
    for i, c in enumerate(calls):
        log("bst_k4_launch", launch=i, **c)
    tot = sum_segsum_calls(calls)
    line = dict(
        batch=b, launches_per_step=got, memory=mem, step_ms=steps_ms,
        median_step_ms=med, samples_per_second=b / (med / 1e3),
        loss=history, loss_first=history[0], loss_last=history[-1],
        device_busy_ms=busy_ms, profiled_seconds=wall_s,
        busy_share=busy_ms / 1e3 / wall_s,
        k4_device_ms=sum(ms for n, ms in per.items() if "segsum" in n),
        top_device_ms=top, k4_step=tot,
        seconds=time.perf_counter() - t_run)
    log("bst_train", **line)
    if len(calls) != 1 or not (tot["within_tol"] and tot["bit_identical"]):
        raise SystemExit(f"bst train: K4 on the recorded launches: "
                         f"{len(calls)} calls, {tot}")
    out["train"] = line
    out["k4"] = tot
    out["embedding_bag"] = bst_k4_shape(cfg, model, dev)
    del model, trainer, stream, loss_fn, calls
    torch.cuda.empty_cache()

    # (f) cover-edge-tc's rmat_smoke through Algorithm 2 in its ring mode
    mod = arch_module("cover-edge-tc")
    edges, n = mod.shape_graph("rmat_smoke")
    eng = TriangleEngine(device=dev, mesh=LocalShards(8, dev))
    eng.count((edges, n), route="distributed", options=mod.options())
    dist, secs, _, got, _ = main_path(lambda c: eng.count(
        (edges, n), route="distributed", options=mod.options()))
    local = eng.count((edges, n), route="local")
    tc = dict(shape="rmat_smoke", triangles=dist.triangles,
              local_triangles=local.triangles, plan_id=dist.plan_id,
              per_device=dist.per_device.tolist(), launches=got,
              seconds=secs, overflow=[dist.overflow.transpose,
                                      dist.overflow.hedge])
    log("bst_cover_edge_tc", **tc)
    if (dist.triangles != local.triangles or dist.triangles
            != EXPECTED[mod.SHAPES["rmat_smoke"]["scale"]][0]
            or dist.plan_id != "hedge/ring/p8" or any(tc["overflow"])
            or not got["intersect_count"]):
        raise SystemExit(f"cover-edge-tc rmat_smoke: {tc}")
    out["cover_edge_tc"] = tc
    out["seconds"] = time.perf_counter() - t_phase
    log("bst_summary", **{k: v for k, v in out.items()
                          if k not in ("train", "serve")})
    return out


# ------------------------------------------------- explicit expert parallel

#: phase 17: qwen2-moe-a2.7b at full width with ``dispatch="a2a"`` under
#: a (data 1, model 4) layout over ``LocalShards(4, "cuda")``, at the
#: training depth cut.  ``prefill``: the server's default request (batch,
#: prompt) and the timed prefills a path; ``train``: (layers, batch, seq,
#: timed steps a path); ``check``: the short batch of the first training
#: step held against the CPU's a2a path
A2A = {"arch": "qwen2-moe-a2.7b", "mesh": (1, 4), "prefill": (4, 32, 5),
       "train": (2, 2, 4096, 3), "check": (1, 128)}
#: phase 17 (b): the int8 gradient psum's shards and its timed calls
PSUM = {"shards": 8, "calls": 20}


def drop_shares(calls, n_slices: int) -> list:
    """The dropped share of (token, expert) entries of each slice
    (calls in slice order, layer after layer)."""
    out = []
    for i in range(n_slices):
        mine = calls[i::n_slices]
        out.append(sum(int((~r.keep).sum()) for _, _, r in mine)
                   / sum(r.keep.numel() for _, _, r in mine))
    return out


def a2a_layer_check(model, cfg, dev, layout) -> dict:
    """Layer 0's MoE FFN on the a2a path on the card against the CPU's a2a
    path on the same weights (copied) and a random [4, 32, d_model]
    input: each slice's routing integers (experts, keep mask) equal, the
    output and aux loss within GNN_TOL; each slice's dropped share
    beside the sort path's on the same input."""
    from repro_torch.core.shards import LocalShards
    from repro_torch.distributed.constrain import use_mesh
    from repro_torch.models import moe as tmoe

    n_model = layout.shape["model"]
    leaves = model.layers[0].moe.leaves()
    cpu_leaves = leaves_on_cpu(leaves)
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    res = {}
    with torch.no_grad():
        with use_mesh(layout, LocalShards(n_model, dev)):
            card = route_calls(lambda: res.setdefault(
                "card", tmoe.moe_ffn(leaves, cfg.moe, x)))
        with use_mesh(layout, LocalShards(n_model, "cpu")):
            cpu = route_calls(lambda: res.setdefault(
                "cpu", tmoe.moe_ffn(cpu_leaves, cfg.moe, x.cpu())))
        sort = route_calls(lambda: tmoe.moe_ffn(leaves, cfg.moe, x))
    (got, aux), (want, aux_cpu) = res["card"], res["cpu"]
    same = [{f: bool(torch.equal(getattr(a[2], f).cpu(), getattr(b[2], f)))
             for f in ("expert_idx", "keep")} for a, b in zip(card, cpu)]
    k = cfg.moe.top_k
    gaps = [float((top[:, k - 1] - top[:, k]).min()) for top in (
        r.probs.sort(-1, descending=True).values for _, _, r in cpu)]
    err, ok = within(got.cpu(), want, GNN_TOL)
    aux_err, aux_ok = within(aux.cpu(), aux_cpu, GNN_TOL)
    out = dict(tokens=x.shape[0] * x.shape[1], slices=len(card),
               slice_tokens=card[0][0], slice_capacity=card[0][1],
               sort_capacity=sort[0][1], max_abs_err=err,
               aux_abs_err=aux_err, aux=float(aux), tol=GNN_TOL,
               within_tol=bool(ok and aux_ok), routing_equal=same,
               smallest_topk_gap=min(gaps),
               drop_share_per_slice=drop_shares(card, n_model),
               drop_share_sort=drop_shares(sort, 1)[0])
    log("a2a_layer_cpu_vs_card", **out)
    if not (out["within_tol"] and len(card) == n_model == len(cpu)
            and all(all(s.values()) for s in same)):
        raise SystemExit(f"the a2a MoE layer on the card differs from the "
                         f"CPU's: {out}")
    return out


def psum_phase(dev) -> dict:
    """Phase 17 (b): ``int8_compressed_psum`` over ``LocalShards(8,
    "cuda")`` on eight per-shard copies of a GatedGCN-sized gradient tree
    (the full config's parameter shapes; standard normals, each shard
    scaled by 10^-u, u uniform in [0, 3), seed 0): equal bit for bit to
    the CPU's, its ms a call, and its largest error against the exact
    float64 sum, relative to each leaf's largest |sum| (the reference's
    shared scale at full size)."""
    from repro_torch.configs.registry import arch_module
    from repro_torch.core.shards import LocalShards
    from repro_torch.launch.mesh import make_tc_mesh
    from repro_torch.launch.steps import shape_model
    from repro_torch.train.trainer import int8_compressed_psum

    p = PSUM["shards"]
    shapes = {k: tuple(v.shape) for k, v in shape_model(
        "gatedgcn", arch_module("gatedgcn").CONFIG).named_parameters()}
    rng = np.random.default_rng(0)
    scale = (10.0 ** -rng.uniform(0, 3, p)).astype(np.float32)
    host = {k: torch.from_numpy((rng.standard_normal((p,) + s).astype(
        np.float32) * scale.reshape((p,) + (1,) * len(s))))
        for k, s in shapes.items()}
    tree = {k: v.to(dev) for k, v in host.items()}
    shards = make_tc_mesh(p, dev)
    got = int8_compressed_psum(tree, shards)
    want = int8_compressed_psum(host, LocalShards(p, "cpu"))
    same = all(torch.equal(got[k].cpu().view(torch.int32),
                           want[k].view(torch.int32)) for k in host)
    ms = cuda_ms(lambda: int8_compressed_psum(tree, shards),
                 reps=PSUM["calls"])
    rel = {}
    for k, v in host.items():
        exact = v.double().sum(0)
        rel[k] = float((got[k].cpu().double() - exact).abs().max()
                       / exact.abs().max().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    out = dict(shards=p, leaves=len(host),
               params=sum(int(np.prod(s)) for s in shapes.values()),
               shard_scales=scale.tolist(), bits_equal_cpu=same, ms=ms,
               max_rel_err=rel[worst], worst_leaf=worst,
               median_rel_err=statistics.median(rel.values()))
    log("a2a_int8_psum", **out)
    if not same:
        raise SystemExit(f"int8_compressed_psum on the card differs from "
                         f"the CPU's: {out}")
    return out


def dryrun_phase() -> dict:
    """Phase 17 (c): every dry-run cell (the 40 assigned and both TC
    shapes) on ``pod`` and ``multipod``, on the host: cells built, skips,
    seconds, and each cell whose per-device argument bytes exceed the
    card's memory."""
    from repro_torch.launch.dryrun import run_cell, select_cells
    from repro_torch.launch.mesh import make_production_mesh

    total = torch.cuda.get_device_properties(0).total_memory
    cells = select_cells(include_tc=True) + [("cover-edge-tc",
                                              "rmat_smoke")]
    out = {"device_memory": total}
    for mesh in ("pod", "multipod"):
        layout = make_production_mesh(multi_pod=mesh == "multipod")
        t0 = time.perf_counter()
        recs = [run_cell(a, s, layout) for a, s in cells]
        secs = time.perf_counter() - t0
        ok = [r for r in recs if r["status"] == "ok"]
        over = {f"{r['arch']}|{r['shape']}": r["argument_bytes"]
                for r in ok if r["argument_bytes"] > total}
        out[mesh] = dict(cells=len(recs), ok=len(ok), seconds=secs,
                         skipped=[f"{r['arch']}|{r['shape']}" for r in recs
                                  if r["status"] == "skipped"],
                         max_argument_bytes=max(r["argument_bytes"]
                                                for r in ok))
        log("a2a_dryrun_over_device_memory", mesh=mesh,
            device_memory=total, cells=over)
        if len(ok) + len(out[mesh]["skipped"]) != len(recs):
            raise SystemExit(f"dry run on {mesh}: a cell failed: {recs}")
    log("a2a_dryrun", **out)
    return out


def a2a_phase(dev, main_path) -> dict:
    """Phase 17: qwen2-moe-a2.7b's explicit expert parallelism on the card,
    the int8 gradient psum and the dry run (see the module's docstring);
    ``main_path`` is ``main``'s.  Returns the phase's summary with K4's
    a2a entries."""
    import contextlib
    import dataclasses

    from repro_torch.configs.data import lm_batch
    from repro_torch.configs.registry import arch_module
    from repro_torch.core.shards import LocalShards
    from repro_torch.distributed.constrain import use_mesh
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.launch.steps import init_for
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    arch = A2A["arch"]
    layers, tb, ts, tsteps = A2A["train"]
    base = arch_module(arch).CONFIG
    cfg = dataclasses.replace(base, n_layers=layers,
                              moe=dataclasses.replace(base.moe,
                                                      dispatch="a2a"))
    layout = make_debug_mesh(A2A["mesh"])
    n_model = layout.shape["model"]
    shards = LocalShards(n_model, dev)

    def mesh(a2a: bool):
        return use_mesh(layout, shards) if a2a else contextlib.nullcontext()

    model = init_for(arch, cfg, 0, dev)
    out = {"draw_seconds": model.init_seconds, "k4": {},
           "params": sum(p.numel() for p in model.parameters())}
    out["layer_check"] = a2a_layer_check(model, cfg, dev, layout)

    # (a) prefill of the default request, a2a against the sort path
    b, p, runs = A2A["prefill"]
    tokens = prompt_tokens(cfg, b, p, dev)

    def prefill(a2a: bool):
        with mesh(a2a):
            return model.prefill(tokens, p)

    prefill(True), prefill(False)                               # warm-up
    with shards.recording() as rec:   # the a2a path, not the sort path
        (logits, _), _, _, got, mem = main_path(lambda c: prefill(True))
    want = {"flash_attention": layers, "segment_sum": layers}
    a2as = sum(c.kind == "all_to_all" for c in rec)
    if {k: v for k, v in got.items() if v} != want or a2as != 2 * layers:
        raise SystemExit(f"a2a prefill: launched {got} and {a2as} "
                         f"all-to-alls; expected {want} and {2 * layers}")
    ms = {True: [], False: []}
    for a2a in (True, False, False, True) * ((runs + 1) // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(a2a)
        torch.cuda.synchronize()
        ms[a2a].append((time.perf_counter() - t0) * 1e3)
    drops = {a2a: route_calls(lambda a=a2a: prefill(a))
             for a2a in (True, False)}
    calls = []
    record_segsum(lambda: prefill(True),
                  lambda m, lay, k: calls.append(time_segsum_call(m, lay,
                                                                  k)))
    out["k4"]["prefill"] = sum_segsum_calls(calls)
    out["k4"]["prefill"].update(e=b * p * cfg.moe.top_k, f=cfg.d_model)
    log("a2a_k4", part="prefill", **out["k4"]["prefill"])
    line = dict(batch=b, prompt=p, launches=got, all_to_alls=a2as,
                memory=mem,
                finite=bool(torch.isfinite(logits).all()),
                a2a_ms=ms[True], sort_ms=ms[False],
                median_a2a_ms=statistics.median(ms[True]),
                median_sort_ms=statistics.median(ms[False]),
                drop_share_per_slice=drop_shares(drops[True], n_model),
                drop_share_sort=drop_shares(drops[False], 1)[0])
    log("a2a_prefill", **line)
    if not line["finite"]:
        raise SystemExit("a2a prefill: the logits are not finite")
    out["prefill"] = line
    del logits

    # (a) training: the first step against the CPU's a2a path at a short
    # batch, then steps through launch/train.py's pieces, a2a and sort
    cb, cs = A2A["check"]
    with use_mesh(layout):  # each device's own LocalShards(4)
        out["cpu_vs_card"] = lm_cpu_check(
            arch, cfg, model, lm_batch(cfg, cb, cs, 0, device=dev),
            "a2a_train_cpu_vs_card")
    args = ltrain.parse_args(["--arch", arch, "--batch", str(tb), "--seq",
                              str(ts), "--steps", str(4 * tsteps + 4)])
    _, stream = ltrain.build_lm_pieces(cfg, args)
    auxes = []

    def loss_fn(m, tok, lab):   # the reference's loss, its aux kept
        logits, aux = m(tok)
        auxes.append(aux.detach())
        return tfm.softmax_xent(logits, lab) + 0.01 * aux

    opt = OptConfig(kind="adamw", lr=3e-4, warmup=10,
                    total_steps=4 * tsteps + 4)
    trainer = Trainer(loss_fn, model, opt, cfg=cfg, log_every=10**9)

    def step(a2a: bool):
        with mesh(a2a):
            return trainer.fit(stream, 1)

    history = step(True)["history"] + step(False)["history"]   # warm-up
    # the record is this thread's: the forward's all-to-alls (the
    # backward's may run on autograd's device thread)
    with shards.recording() as rec:
        rep, _, _, got, mem = main_path(lambda c: step(True))
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "segment_sum": 2 * layers}
    a2as = sum(c.kind == "all_to_all" for c in rec)
    if {k: v for k, v in got.items() if v} != want or a2as < 2 * layers:
        raise SystemExit(f"a2a train: launched {got} and {a2as} "
                         f"all-to-alls; expected {want} and at least "
                         f"{2 * layers}")
    history += rep["history"]
    step_ms = {True: [], False: []}
    for a2a in (True, False, False, True) * ((tsteps + 1) // 2):
        r = step(a2a)
        history += r["history"]
        step_ms[a2a] += [s * 1e3 for s in r["step_seconds"]]
    busy_ms, wall_s, top, per = device_busy(lambda: step(True))
    calls = []
    record_segsum(lambda: step(True),
                  lambda m, lay, k: calls.append(time_segsum_call(m, lay,
                                                                  k)))
    out["k4"]["train"] = sum_segsum_calls(calls)
    out["k4"]["train"].update(e=tb * ts * cfg.moe.top_k, f=cfg.d_model)
    log("a2a_k4", part="train", **out["k4"]["train"])
    line = dict(layers=layers, batch=tb, seq=ts, launches_per_step=got,
                all_to_alls_this_thread=a2as, memory=mem, loss=history,
                aux_loss=[float(a) for a in auxes],
                a2a_step_ms=step_ms[True], sort_step_ms=step_ms[False],
                median_a2a_step_ms=statistics.median(step_ms[True]),
                median_sort_step_ms=statistics.median(step_ms[False]),
                device_busy_ms=busy_ms, profiled_seconds=wall_s,
                busy_share=busy_ms / 1e3 / wall_s,
                k4_device_ms=sum(ms for n, ms in per.items()
                                 if "segsum" in n),
                top_device_ms=top)
    log("a2a_train", **line)
    if not np.isfinite(history).all():
        raise SystemExit(f"a2a train: a loss is not finite: {history}")
    out["train"] = line
    bad = [t for t, v in out["k4"].items()
           if not (v["within_tol"] and v["bit_identical"] and v["launches"])]
    if bad:
        raise SystemExit(f"K4 at the a2a shapes: {bad}: {out['k4']}")
    del model, trainer, stream, tokens
    torch.cuda.empty_cache()

    out["psum"] = psum_phase(dev)
    out["dryrun"] = dryrun_phase()
    out["seconds"] = time.perf_counter() - t_phase
    log("a2a_summary", **{k: v for k, v in out.items()
                          if k not in ("prefill", "train")})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20, choices=sorted(EXPECTED),
                    help="RMAT scale of the full-size phase (default 20); "
                         "only scales whose count is known")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed full-size runs of each path after its "
                         "warm-up")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.intersect import cell_chunks
    from repro_torch.core.sequential import StageClock
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import from_edges
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.intersect import intersect as kmod
    from repro_torch.kernels.intersect.ref import intersect_levels_ref
    from repro_torch.kernels.segsum import segsum as k4

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    launches = kmod.LAUNCHES
    pv_opts = TCOptions(per_vertex=True)

    def reset_launches():
        for c in (launches, fa.LAUNCHES, k4.LAUNCHES):
            for k in c:
                c[k] = 0

    def main_path(run):
        """``run(clock)`` once with every launch counter set to 0 just
        before and read just after: ``(result, seconds, clock, launches,
        memory)``, ``memory`` the device bytes allocated before the run
        and at its peak."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem = {"allocated_before": torch.cuda.memory_allocated()}
        reset_launches()
        clock = StageClock(dev)
        t0 = time.perf_counter()
        res = run(clock)
        dt = time.perf_counter() - t0
        got = {**launches, **fa.LAUNCHES, **k4.LAUNCHES}
        mem["max_allocated"] = torch.cuda.max_memory_allocated()
        return res, dt, clock, got, mem

    def timed_runs(tag, run, agrees):
        """``args.runs`` timed runs of ``run(clock)``, each checked by
        ``agrees``; logs and returns the median line."""
        runs = []
        for i in range(args.runs):
            clock = StageClock(dev)
            t0 = time.perf_counter()
            r = run(clock)
            dt = time.perf_counter() - t0
            if not agrees(r):
                raise SystemExit(f"{tag}: timed run {i} disagrees")
            runs.append((dt, clock))
            log("timed_run", path=tag, run=i, seconds=dt,
                stages=clock.seconds, counts=clock.counts)
        med_clock = sorted(runs, key=lambda x: x[0])[len(runs) // 2][1]
        line = dict(path=tag, graph=f"rmat{args.scale}",
                    median_seconds=statistics.median(dt for dt, _ in runs),
                    seconds=[dt for dt, _ in runs],
                    median_run_stages=med_clock.seconds,
                    bfs_sweeps=med_clock.counts.get("bfs_sweeps"))
        log("end_to_end", **line)
        return line

    # ---------------------------------------------------------- 1. setup
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")
    log("setup", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)),
        nvidia_smi=card,
        nvcc=sh(build.nvcc_path(), "--version").splitlines()[-1])
    t0 = time.perf_counter()
    build.build_all()  # one nvcc per source, all at once
    for name in build.SOURCES:
        build.library(name)
    log("build", seconds=time.perf_counter() - t0,
        sources={k: {"nvcc_seconds": s, "ptxas": e.strip().splitlines()}
                 for k, (s, e) in build.BUILD_LOG.items()})
    # K5's backward: bf16 products on the tensor cores, float32 on FMA,
    # no atomics (its sums run in a fixed order)
    census = sass_census(build.library("flash_attention_bwd")._name)
    log("k5_bwd_sass", kernels=census)
    if not census:
        raise SystemExit("cuobjdump found no kernel in K5's backward")
    for fn, c in census.items():
        if c["atomics"] or (c["HMMA"] > 0) != ("_mma<" in fn):
            raise SystemExit(f"K5's backward {fn}: {c}")
    eng = TriangleEngine(device=dev)
    max_err = 0
    max_err_hits = 0
    max_err_count = 0

    # ----------------------------- 2. kernels vs plain, rmat(16) every row
    e16, n16 = gen.rmat(16, 16, seed=0)
    res16 = eng.count_raw((e16, n16))
    flat, buckets = bucket_operands(from_edges(e16, n16, device=dev),
                                    res16.levels, res16.plan)
    before = dict(launches)
    for b, ops in buckets:
        err, s1, s2, _ = compare(flat, res16.levels, ops, b)
        err_h, hits, _, _ = compare_hits(flat, ops, b)
        kw16 = dict(d_cand=b.d_cand, d_targ=b.d_targ)
        err_c, err_c12, hits_c, _ = compare_count(flat, ops, kw16,
                                                  res16.levels)
        # K1, K2 and K3 with every live row on the bitmap, and on the walk
        err_p = max(max(compare(flat, res16.levels, ops, b, path=p)[0],
                        compare_hits(flat, ops, b, path=p)[0])
                    for p in PATHS_TIMED)
        err_cp = max(compare_count(flat, ops, kw16, path=p)[0]
                     for p in K3_PATHS_TIMED)
        max_err = max(max_err, err, err_p)
        max_err_hits = max(max_err_hits, err_h, err_p)
        max_err_count = max(max_err_count, err_c, err_c12, err_cp)
        log("kernel_vs_plain", graph="rmat16", rows=b.rows, d_cand=b.d_cand,
            d_targ=b.d_targ, max_abs_err=err, c1=s1, c2=s2,
            hits_max_abs_err=err_h, hits=hits, count_max_abs_err=err_c,
            count_vs_c1_c2_max_abs_err=err_c12, count_hits=hits_c,
            forced_paths_max_abs_err=err_p,
            count_forced_paths_max_abs_err=err_cp,
            count_path=kmod.count_path(len(ops[0]), b.d_cand),
            **layout_stats(ops, b))
        if hits != s1 + s2 or hits_c != s1 + s2:
            raise SystemExit(f"rmat16: K2 found {hits} hits, K3 {hits_c}, "
                             f"K1 {s1 + s2}")
    if any(launches[k] <= before[k] for k in launches) or max(
            max_err, max_err_hits, max_err_count):
        raise SystemExit(f"rmat16 kernel check failed: err={max_err}, "
                         f"{max_err_hits}, {max_err_count}, launches "
                         f"{before} -> {launches}")

    # ----------------------------------------------- 3. small graphs
    small = [("karate", gen.karate(), (45, None))]
    small += [(f"rmat{s}", gen.rmat(s, 16, seed=0), EXPECTED[s])
              for s in (10, 12, 16)]
    for name, (edges, n), (tri, nh) in small:
        reset_launches()
        t0 = time.perf_counter()
        r = eng.count((edges, n))
        dt = time.perf_counter() - t0
        log("small", graph=name, triangles=r.triangles,
            num_horizontal=r.num_horizontal, backend=r.backend,
            launches=dict(launches), seconds=dt)
        if (r.triangles != tri or (nh is not None and r.num_horizontal != nh)
                or r.backend != "cuda" or r.overflow
                or launches["intersect_levels"] == 0
                or launches["intersect_hits"] or launches["intersect_count"]):
            raise SystemExit(f"{name}: wrong count or path: {r}")
    # the card's per-vertex credit and found list at rmat12 against the
    # port's CPU path, array for array
    e12, n12 = gen.rmat(12, 16, seed=0)
    cpu = TriangleEngine(device="cpu")
    t0 = time.perf_counter()
    pv_gpu = eng.count((e12, n12), options=pv_opts)
    tri_gpu, cnt_gpu = eng.find((e12, n12), max_triangles=EXPECTED[12][0])
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv_cpu = cpu.count((e12, n12), options=pv_opts)
    tri_cpu, cnt_cpu = cpu.find((e12, n12), max_triangles=EXPECTED[12][0])
    cpu_s = time.perf_counter() - t0
    same12 = (np.array_equal(pv_gpu.per_vertex, pv_cpu.per_vertex)
              and np.array_equal(pv_gpu.degrees, pv_cpu.degrees)
              and (pv_gpu.c1, pv_gpu.c2) == (pv_cpu.c1, pv_cpu.c2)
              and int(cnt_gpu) == int(cnt_cpu) == EXPECTED[12][0]
              and torch.equal(tri_gpu.cpu(), tri_cpu))
    log("rmat12_gpu_vs_cpu", per_vertex_sum=int(pv_gpu.per_vertex.sum()),
        triangles=pv_gpu.triangles, found=int(cnt_gpu), equal=same12,
        gpu_seconds=gpu_s, cpu_seconds=cpu_s)
    if not same12:
        raise SystemExit("rmat12: the card's per-vertex credit or found "
                         "list differs from the CPU path")
    # two rmat12 stream sessions (without and with credit), the same
    # stream on the card and on the CPU: every StreamUpdate and the final
    # arrays equal, batch for batch (the 6,000-update apply is two
    # internal batches)
    for pv12 in (False, True):
        o12 = TCOptions(per_vertex=pv12, stream_staleness=1e9)
        sg = eng.stream((e12, n12), options=o12)
        sc = cpu.stream((e12, n12), options=o12)
        rng12 = np.random.default_rng(12)
        for k12 in (2000, 6000, 4096):
            batch = mutation_batch(rng12, sc.state.edges(), n12, k12)
            ug, uc = sg.apply(batch), sc.apply(batch)
            if ug != uc:
                raise SystemExit(f"rmat12 stream (per_vertex={pv12}): the "
                                 f"card's update differs from the CPU's")
        ug, uc = sg.apply([], refresh=True), sc.apply([], refresh=True)
        rg, rc = sg.count(), sc.count()
        same = (ug == uc and np.array_equal(sg.state.edges(),
                                            sc.state.edges())
                and np.array_equal(sg.state.deg, sc.state.deg)
                and (rg.triangles, rg.c1, rg.c2, rg.k, rg.num_horizontal)
                == (rc.triangles, rc.c1, rc.c2, rc.k, rc.num_horizontal)
                and np.array_equal(rg.levels, rc.levels)
                and (not pv12 or np.array_equal(rg.per_vertex,
                                                rc.per_vertex)))
        log("rmat12_stream_gpu_vs_cpu", per_vertex=pv12,
            triangles=rg.triangles, batches=sg.batches, probes=sg.probes,
            equal=same)
        if not same:
            raise SystemExit(f"rmat12 stream (per_vertex={pv12}): the "
                             f"card's session differs from the CPU's")

    # -------------------------------------------------- 4. full size
    scale = args.scale
    t0 = time.perf_counter()
    edges, n = gen.rmat(scale, 16, seed=0)
    log("data", graph=f"rmat{scale}", n_nodes=n, edge_rows=len(edges),
        generate_seconds=time.perf_counter() - t0)
    expect = EXPECTED[scale]
    n_tri = expect[0]
    e2e = {}

    # 4a. the count: K1 only
    report, warm_s, clock, count_launches, mem = main_path(
        lambda c: eng.count((edges, n), clock=c))
    memory = {"count": mem}
    log("main_path", path="count", graph=f"rmat{scale}", memory=mem,
        triangles=report.triangles, num_horizontal=report.num_horizontal,
        k=report.k, c1=report.c1, c2=report.c2,
        overflow_h=report.overflow.h, backend=report.backend,
        plan_id=report.plan_id, launches=count_launches, seconds=warm_s,
        stages=clock.seconds, counts=clock.counts)
    if (count_launches["intersect_levels"] == 0
            or count_launches["intersect_hits"]
            or count_launches["intersect_count"]
            or report.backend != "cuda"):
        raise SystemExit(f"the count did not go through K1 alone: "
                         f"{count_launches}")
    if (report.triangles, report.num_horizontal) != expect:
        raise SystemExit(f"rmat{scale}: got {report.triangles} triangles, "
                         f"{report.num_horizontal} horizontal; "
                         f"expected {expect}")
    if report.overflow.h:
        raise SystemExit(f"rmat{scale}: overflow flag set")
    e2e["count"] = timed_runs(
        "count", lambda c: eng.count((edges, n), clock=c),
        lambda r: (r.triangles, r.c1, r.c2) == (report.triangles, report.c1,
                                                report.c2))

    # 4b. the per-vertex count: K2 only
    pv, warm_s, clock, pv_launches, mem = main_path(
        lambda c: eng.count((edges, n), options=pv_opts, clock=c))
    memory["per_vertex"] = mem
    pv_sum = int(pv.per_vertex.astype(np.int64).sum())
    log("main_path", path="per_vertex", graph=f"rmat{scale}", memory=mem,
        triangles=pv.triangles, c1=pv.c1, c2=pv.c2, per_vertex_sum=pv_sum,
        top_k=pv.top_k(5).tolist(), transitivity=pv.transitivity(),
        launches=pv_launches, seconds=warm_s, stages=clock.seconds,
        counts=clock.counts)
    if (pv_launches["intersect_hits"] == 0 or pv_launches["intersect_levels"]
            or pv_launches["intersect_count"]):
        raise SystemExit(f"the per-vertex count did not go through K2 "
                         f"alone: {pv_launches}")
    if ((pv.triangles, pv.c1, pv.c2) != (report.triangles, report.c1,
                                         report.c2)
            or pv_sum != 3 * n_tri):
        raise SystemExit(f"rmat{scale} per-vertex: triangles "
                         f"{pv.triangles}, c1/c2 {pv.c1}/{pv.c2}, sum "
                         f"{pv_sum}")
    e2e["per_vertex"] = timed_runs(
        "per_vertex",
        lambda c: eng.count((edges, n), options=pv_opts, clock=c),
        lambda r: np.array_equal(r.per_vertex, pv.per_vertex))

    # 4c. find, with a buffer of every triangle: K2 only.  The triangles
    # are unique and closed, and their corners are the per-vertex credit.
    (tri, cnt), warm_s, clock, find_launches, mem = main_path(
        lambda c: eng.find((edges, n), max_triangles=n_tri, clock=c))
    memory["find"] = mem
    g = from_edges(edges, n, device=dev)
    t0 = time.perf_counter()
    unique, closed = check_found(tri, g, n)
    found = sum(torch.bincount(tri[:, i], minlength=n) for i in range(3))
    pv_found = bool(torch.equal(
        found, torch.from_numpy(pv.per_vertex).to(dev, torch.int64)))
    del found
    log("main_path", path="find", graph=f"rmat{scale}", memory=mem,
        count=int(cnt), rows=tri.shape[0], unique=unique, closed=closed,
        per_vertex_equals_bincount=pv_found, launches=find_launches,
        seconds=warm_s, stages=clock.seconds, counts=clock.counts,
        check_seconds=time.perf_counter() - t0)
    if (find_launches["intersect_hits"] == 0
            or find_launches["intersect_levels"]
            or find_launches["intersect_count"]):
        raise SystemExit(f"find did not go through K2 alone: "
                         f"{find_launches}")
    if (int(cnt) != n_tri or not (unique and closed and pv_found)
            or tri.device.type != "cuda"):
        raise SystemExit(f"rmat{scale} find: count {int(cnt)}, unique "
                         f"{unique}, closed {closed}, per-vertex credit "
                         f"equals its bincount {pv_found}")
    e2e["find"] = timed_runs(
        "find", lambda c: eng.find((edges, n), max_triangles=n_tri, clock=c),
        lambda r: int(r[1]) == n_tri and torch.equal(r[0], tri))
    del tri

    # 4d. the device's busy share on each path: one profiled run each,
    # its device time over the unprofiled median wall time
    for tag, run in (
        ("count", lambda: eng.count((edges, n))),
        ("per_vertex", lambda: eng.count((edges, n), options=pv_opts)),
        ("find", lambda: eng.find((edges, n), max_triangles=n_tri)),
    ):
        busy_ms, wall_s, top, _ = device_busy(run)
        med = e2e[tag]["median_seconds"]
        e2e[tag]["device_busy_ms"] = busy_ms
        log("device_busy", path=tag, busy_ms=busy_ms,
            profiled_seconds=wall_s, median_seconds=med,
            busy_share=busy_ms / 1e3 / med if busy_ms else None,
            top_device_ms=top)

    # 4e. per bucket: each kernel's time, bound, plain time and
    # agreement, on the operands the main path gives it
    levels = torch.from_numpy(report.levels).to(dev)
    plan = eng.count_raw(g).plan
    log("plan", buckets=[vars(b) for b in plan.buckets],
        probe_rows=plan.probe_rows, probe_cells=plan.probe_cells,
        peak_rows=plan.peak_rows)
    flat, buckets = bucket_operands(g, levels, plan)
    rng = np.random.default_rng(0)
    sums = ("ms", "plain_ms", "bound_ms", "search_bound_ms",
            "row_bytes_bound_ms")
    tot = dict.fromkeys(sums, 0.0)
    tot_h = dict(dict.fromkeys(sums, 0.0), host_paced_ms=0.0,
                 sample_ms=0.0, sample_plain_ms=0.0, sample_rows=0,
                 launches=0)
    tot_c = dict(dict.fromkeys(sums, 0.0), host_paced_ms=0.0)
    # K1, K2 and K3 with every live row on one path: the same launches,
    # timed beside the rule by shape
    tot_p = {k: dict.fromkeys(PATHS_TIMED, 0.0) for k in ("k1", "k2")}
    tot_p["k3"] = dict.fromkeys(K3_PATHS_TIMED, 0.0)
    paths_c = []
    bound_by, bound_by_h, bound_by_c = [], [], []
    top_sample = None
    for b, ops in buckets:
        kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
        call = (flat, *ops[:4], levels, ops[4])
        # K1: the whole wrapper call (layout included) on the device,
        # the host's enqueue hidden; one call profiled by kernel name
        ms = device_ms(lambda: kmod.intersect_levels(*call, **kw))
        _, k1_by_name = profiled_ms(lambda: kmod.intersect_levels(*call,
                                                                  **kw))
        ref1 = kmod.intersect_levels(*call, **kw)
        path_ms, path_err = {}, max(  # a second launch: same bits
            int((x - y).abs().max().item()) if len(x) else 0
            for x, y in zip(kmod.intersect_levels(*call, **kw), ref1))
        for p in PATHS_TIMED:
            path_ms[p] = device_ms(
                lambda: kmod.intersect_levels(*call, path=p, **kw))
            got = kmod.intersect_levels(*call, path=p, **kw)
            path_err = max(path_err, *(
                int((x - y).abs().max().item()) if len(x) else 0
                for x, y in zip(got, ref1)))
            tot_p["k1"][p] += path_ms[p]
        err_full, s1, s2, plain_ms = compare(flat, levels, ops, b)
        rows = torch.from_numpy(np.sort(rng.choice(
            b.count, size=min(SAMPLE_ROWS, b.count), replace=False))).to(dev)
        err_sample = compare(flat, levels, ops, b, rows)[0]
        max_err = max(max_err, err_full, err_sample, path_err)
        bd = bucket_bound(flat, levels, ops, b.d_cand, b.d_targ, s1 + s2)
        for key, v in (("ms", ms), ("plain_ms", plain_ms)):
            tot[key] += v
        for key in sums[2:]:
            tot[key] += bd[key]
        bound_by.append((bd["bound_ms"], bd["bound_by"]))
        stats = layout_stats(ops, b)
        log("bucket", kernel="intersect_levels", graph=f"rmat{scale}",
            start=b.start, count=b.count, rows=b.rows, d_cand=b.d_cand,
            d_targ=b.d_targ, kernel_ms=ms, device_ms_by_name=k1_by_name,
            path_ms=path_ms, plain_ms=plain_ms,
            max_abs_err_all_rows=err_full, max_abs_err_sample=err_sample,
            paths_and_repeat_max_abs_err=path_err, c1=s1, c2=s2, **bd,
            **stats)
        top_sample = (b, tuple(x[rows] for x in ops))

        # K2 at the main path's own launch shapes: one call of the
        # wrapper per chunk of the cell budget (its offsets cumsum, its
        # layout and the size's read-back included), each timed, held
        # against the plain version on the same rows and launched again
        # by each path (the same bits); the times summed over the
        # chunks.  The read-back inside the call paces it by the host:
        # its device time (ms) is one profiled call's summed kernels,
        # copies and fills, its host-paced time the CUDA events around
        # the call
        ms_h = host_h = p_ms_h = 0.0
        n_hits = err_all = 0
        paths_h = dict.fromkeys(PATHS_TIMED, 0.0)
        k2_by_name: dict = {}
        chunks = cell_chunks(ops[1], d_cand=b.d_cand)
        for r0, r1 in chunks:
            cops = tuple(x[r0:r1] for x in ops[:4])
            host_h += cuda_ms(lambda: kmod.intersect_hits(flat, *cops, **kw))
            dev_c, by_name = profiled_ms(
                lambda: kmod.intersect_hits(flat, *cops, **kw))
            ms_h += dev_c
            for name, v in by_name.items():
                k2_by_name[name] = k2_by_name.get(name, 0.0) + v
            err_c, hits_c, _, p_c = compare_hits(flat, cops, b)
            ko, kh = kmod.intersect_hits(flat, *cops, **kw)
            for p in PATHS_TIMED:
                paths_h[p] += cuda_ms(
                    lambda: kmod.intersect_hits(flat, *cops, path=p, **kw))
                po, ph = kmod.intersect_hits(flat, *cops, path=p, **kw)
                if not (torch.equal(po, ko) and torch.equal(ph, kh)):
                    err_c = max(err_c, 1)
            del ko, kh, po, ph
            err_all = max(err_all, err_c)
            n_hits += hits_c
            p_ms_h += p_c
        for p in PATHS_TIMED:
            tot_p["k2"][p] += paths_h[p]
        bd_h = hits_bound(flat, ops, b.d_cand, b.d_targ)
        err_h, _, k_ms, p_ms = compare_hits(flat, ops, b, rows)
        max_err_hits = max(max_err_hits, err_all, err_h)
        for key, v in (("ms", ms_h), ("host_paced_ms", host_h),
                       ("plain_ms", p_ms_h),
                       ("sample_ms", k_ms), ("sample_plain_ms", p_ms),
                       ("sample_rows", len(rows)),
                       ("launches", len(chunks))):
            tot_h[key] += v
        for key in sums[2:]:
            tot_h[key] += bd_h[key]
        bound_by_h.append((bd_h["bound_ms"], bd_h["bound_by"]))
        log("bucket", kernel="intersect_hits", graph=f"rmat{scale}",
            count=b.count, rows=b.rows, d_cand=b.d_cand, d_targ=b.d_targ,
            hits=n_hits, main_path_launches=len(chunks), kernel_ms=ms_h,
            host_paced_ms=host_h, device_ms_by_name=k2_by_name,
            host_paced_path_ms=paths_h, plain_ms=p_ms_h,
            max_abs_err_all_rows_paths_and_repeat=err_all,
            sample_rows=len(rows), sample_kernel_ms=k_ms,
            sample_plain_ms=p_ms, max_abs_err_sample=err_h,
            library_ms=None, **bd_h, **stats)
        if n_hits != s1 + s2:
            raise SystemExit(f"rmat{scale}: K2 found {n_hits} hits in a "
                             f"bucket, K1 {s1 + s2}")

        # K3 at full width: the count's plan run level-free, one launch
        # per bucket: the wrapper call whole on the device (the host's
        # enqueue hidden) by the rule and by each forced path, host-paced
        # by the rule, one call profiled by kernel name; every row
        # against its plain version and against K1's c1 + c2 (each row's
        # entries are unique), each path launched twice and equal to it
        call_c = (flat, *ops[:4])
        ms_c = device_ms(lambda: kmod.intersect_count(*call_c, **kw))
        host_c = cuda_ms(lambda: kmod.intersect_count(*call_c, **kw))
        _, k3_by_name = profiled_ms(lambda: kmod.intersect_count(*call_c,
                                                                 **kw))
        err_c, err_c12, hits_c, p_ms_c = compare_count(flat, ops, kw, levels)
        ref3 = kmod.intersect_count(*call_c, **kw)
        path_ms_c = {}
        for p in K3_PATHS_TIMED:
            path_ms_c[p] = device_ms(
                lambda: kmod.intersect_count(*call_c, path=p, **kw))
            tot_p["k3"][p] += path_ms_c[p]
            for _ in range(2):
                got = kmod.intersect_count(*call_c, path=p, **kw)
                err_c = max(err_c, int((got - ref3).abs().max().item()))
        del ref3
        max_err_count = max(max_err_count, err_c, err_c12)
        bd_c = count_bound(flat, ops, b.d_cand, b.d_targ)
        for key, v in (("ms", ms_c), ("plain_ms", p_ms_c),
                       ("host_paced_ms", host_c)):
            tot_c[key] += v
        for key in sums[2:]:
            tot_c[key] += bd_c[key]
        bound_by_c.append((bd_c["bound_ms"], bd_c["bound_by"]))
        stats_c = layout_stats(ops, b, k3=True)
        paths_c.append(stats_c["path"])
        log("bucket", kernel="intersect_count", graph=f"rmat{scale}",
            count=b.count, rows=b.rows, d_cand=b.d_cand, d_targ=b.d_targ,
            hits=hits_c, kernel_ms=ms_c, host_paced_ms=host_c,
            path_ms=path_ms_c, device_ms_by_name=k3_by_name,
            plain_ms=p_ms_c,
            max_abs_err_all_rows_paths_and_repeat=err_c,
            max_abs_err_vs_c1_c2=err_c12, library_ms=None, **bd_c,
            **stats_c)
        if hits_c != s1 + s2:
            raise SystemExit(f"rmat{scale}: K3 found {hits_c} hits in a "
                             f"bucket, K1 {s1 + s2}")
    # the plain version of K1 on the top bucket's sample, beside the kernel
    b, sops = top_sample
    kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
    scall = (flat, *sops[:4], levels, sops[4])
    s_kernel = cuda_ms(lambda: kmod.intersect_levels(*scall, **kw))
    s_plain = cuda_ms(lambda: intersect_levels_ref(*scall, **kw), reps=1)
    log("top_bucket_sample", rows=len(sops[0]), d_cand=b.d_cand,
        d_targ=b.d_targ, kernel_ms=s_kernel, plain_ms=s_plain,
        library_ms=None)
    if max_err or max_err_hits or max_err_count:
        raise SystemExit(f"a kernel disagrees with its plain version: "
                         f"K1 {max_err}, K2 {max_err_hits}, K3 "
                         f"{max_err_count}")
    n_buckets, k1_sample_rows = len(buckets), len(sops[0])
    del flat, buckets, top_sample, sops, scall, levels, g
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 5. stream
    stream = stream_phase(eng, edges, n, main_path)

    # ------------------------------------------------------------- 6. lm
    lm = lm_phase(dev, main_path)

    # ------------------------------------------------------------ 7. gnn
    gnn = gnn_phase(dev, main_path)

    # ------------------------------------------------------- 8. serve_tc
    stc = serve_tc_phase(dev, main_path, args.runs)
    ls = stc["launch_sums"]
    stc1, stc1x, stc2 = ls["bounded"], ls["exact"], ls["per_vertex"]

    # --------------------------------------------------------- 9. robust
    rob = robust_phase(dev, main_path, scale, edges, n, n_tri, stc)
    rob_k1 = (sum(v["launches"] for v in rob["deadlines"].values())
              + rob["chaos"]["launches"]["intersect_levels"])

    # ---------------------------------------------------- 10. distributed
    dist = distributed_phase(dev, main_path, args.runs, scale, edges, n,
                             expect)
    dk3, dk2 = dist["k3"], dist["k2"]
    dk2_launches = dist["per_vertex"]["launches"]["intersect_hits"]

    # ----------------------------------------------------------- 11. tune
    tune = tune_phase(dev, main_path, stc)
    tk1 = tune["k1"]

    # ---------------------------------------------------------- 12. audit
    aud = audit_phase(dev, main_path)

    # -------------------------------------------------------- 13. gnn_zoo
    zoo = gnn_zoo_phase(dev, main_path)
    zk = zoo["k4"]
    gnn["kernel"].update({
        "zoo_launches": {k: v["launches"] for k, v in zk.items()},
        "matches_plain": gnn["kernel"]["matches_plain"] and all(
            v["within_tol"] for v in zk.values()),
        "max_abs_err": max(gnn["kernel"]["max_abs_err"],
                           *(v["max_abs_err"] for v in zk.values())),
        "max_scaled_err": max(gnn["kernel"]["max_scaled_err"],
                              *(v["max_scaled_err"] for v in zk.values())),
        "zoo": {tag: {k: v[k] for k in (
            "launches", "ms", "host_paced_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err", "max_scaled_err")}
            for tag, v in zk.items()},
        "zoo_shape": "phase 13: every K4 launch of one training step of "
                     "each run, timed and held against its plain version "
                     "summed in float64: GAT on Cora (F 8, 64, 1, 7) and "
                     "on a sampled minibatch_lg block, SchNet (F 64 x 3, "
                     "then 1) and DimeNet (F 128 x 7, then 1) on the "
                     "molecule shape"})

    # ------------------------------------------------------- 14. lm_train
    lmt = lm_train_phase(dev, main_path)
    lm["kernel"].update({
        "train_launches_per_step": lmt["run"]["launches_per_step"][
            "flash_attention"],
        "train_step_device_ms": lmt["run"]["k5_fwd_device_ms"],
        "train_lse_max_abs_err": max(c["lse_max_abs_err"]
                                     for c in lmt["cases"])})

    # ------------------------------------------------------------ 15. moe
    moe = moe_phase(dev, main_path)
    lm["kernel"]["moe_serve_launches"] = moe["serve"]["launches"][
        "flash_attention"]
    gnn["kernel"].update({
        "moe_launches": {"serve": moe["serve"]["launches"]["segment_sum"],
                         "train_step": moe["train"]["launches_per_step"][
                             "segment_sum"]},
        "matches_plain": gnn["kernel"]["matches_plain"] and all(
            v["within_tol"] for v in moe["k4"].values()),
        "max_scaled_err": max(gnn["kernel"]["max_scaled_err"],
                              *(v["max_scaled_err"]
                                for v in moe["k4"].values())),
        "moe": {tag: {k: v[k] for k in (
            "e", "f", "launches", "ms", "host_paced_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_scaled_err")} for tag, v in moe["k4"].items()},
        "moe_shape": "phase 15: qwen2-moe-a2.7b's expert combine (T tokens "
                     "of T x 4 rows, F = d_model 2,048): every launch of a "
                     "prefill of 4 x 32 tokens (512 rows) and of one decode "
                     "step (16 rows) at full depth, and of one 2-layer "
                     "training step of 2 x 4,096 tokens (32,768 rows), "
                     "each timed and held against its plain version "
                     "summed in float64"})

    # ------------------------------------------------------------ 16. bst
    bst = bst_phase(dev, main_path)
    bk = bst["k4"]
    gnn["kernel"].update({
        "bst_launches": {"train_step": bst["train"]["launches_per_step"][
            "segment_sum"], **{tag: v["launches"]["segment_sum"]
                               for tag, v in bst["serve"].items()}},
        "matches_plain": gnn["kernel"]["matches_plain"] and bk["within_tol"],
        "max_abs_err": max(gnn["kernel"]["max_abs_err"], bk["max_abs_err"]),
        "max_scaled_err": max(gnn["kernel"]["max_scaled_err"],
                              bk["max_scaled_err"]),
        "bst": {**{k: bk[k] for k in (
            "launches", "ms", "host_paced_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bytes", "max_abs_err", "max_scaled_err",
            "bit_identical")},
            **{f"whole_function_{k}": v for k, v in bst[
                "embedding_bag"].items()}},
        "bst_shape": "phase 16: BST's profile bags in one training step at "
                     "train_batch (524,288 lookups into 65,536 bags, F 32): "
                     "its one launch timed and held against its plain "
                     "version summed in float64; library: index_add_; "
                     "whole_function_*: the gather, the layout and K4 "
                     "(embedding_bag) against F.embedding_bag(mode='sum')"})

    # ------------------------------------------------------------ 17. a2a
    a2a = a2a_phase(dev, main_path)
    ak = a2a["k4"]
    gnn["kernel"].update({
        "a2a_launches": {"prefill": a2a["prefill"]["launches"][
            "segment_sum"], "train_step": a2a["train"]["launches_per_step"][
            "segment_sum"]},
        "matches_plain": gnn["kernel"]["matches_plain"] and all(
            v["within_tol"] for v in ak.values()),
        "max_abs_err": max(gnn["kernel"]["max_abs_err"],
                           *(v["max_abs_err"] for v in ak.values())),
        "max_scaled_err": max(gnn["kernel"]["max_scaled_err"],
                              *(v["max_scaled_err"] for v in ak.values())),
        "a2a": {tag: {k: v[k] for k in (
            "e", "f", "launches", "ms", "host_paced_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_scaled_err")} for tag, v in ak.items()},
        "a2a_shape": "phase 17: qwen2-moe-a2.7b's expert combine on the "
                     "explicit expert-parallel path (4 model slices on "
                     "LocalShards(4), one launch a layer for all of them, "
                     "F = d_model 2,048): every launch of a 2-layer "
                     "prefill of 4 x 32 tokens (512 rows) and of one "
                     "2-layer training step of 2 x 4,096 tokens (32,768 "
                     "rows), each timed and held against its plain "
                     "version summed in float64"})

    # --------------------------------------------------------- 18. summary
    log("summary", end_to_end={k: v["median_seconds"] for k, v in e2e.items()},
        device_busy_ms={k: v["device_busy_ms"] for k, v in e2e.items()},
        memory=memory, stream_updates_per_second={
            "batch_4096": stream["timed"]["median_updates_per_second"],
            "one_percent": stream["one_percent"]["updates_per_second"],
            "per_vertex_4096":
                stream["per_vertex"]["median_updates_per_second"]},
        stream_recount_seconds=stream["one_percent"]["recount_seconds"],
        lm_serve={tag: {k: r[k] for k in (
            "median_prefill_ms", "median_decode_ms_per_step",
            "decode_tokens_per_second", "memory", "busy_share")}
            for tag, r in lm["requests"].items()},
        gnn_train={tag: {k: r[k] for k in (
            "median_step_ms", "steps_per_second", "loss_first", "loss_last",
            "memory", "busy_share")} for tag, r in gnn["runs"].items()},
        gnn_zoo_train={tag: {k: r[k] for k in (
            "median_step_ms", "steps_per_second", "loss_first", "loss_last",
            "memory", "busy_share", "model_step_tflops_per_s")}
            for tag, r in zoo["runs"].items()},
        gnn_zoo_seconds=zoo["seconds"],
        lm_train={k: lmt["run"][k] for k in (
            "median_step_ms", "tokens_per_second", "loss_first",
            "loss_last", "memory", "busy_share", "model_tflops_per_s",
            "launches_per_step", "k5_fwd_device_ms", "k5_bwd_device_ms")},
        lm_train_seconds=lmt["seconds"],
        moe_serve={k: moe["serve"][k] for k in (
            "median_prefill_ms", "median_decode_ms_per_step",
            "decode_tokens_per_second", "memory", "busy_share",
            "launches_per_token", "drop_fraction")},
        moe_train={k: moe["train"][k] for k in (
            "median_step_ms", "tokens_per_second", "loss_first",
            "loss_last", "memory", "busy_share", "launches_per_step",
            "k4_device_ms")},
        moe_draw_seconds=moe["draw_seconds"], moe_seconds=moe["seconds"],
        bst={"train": {k: bst["train"][k] for k in (
            "median_step_ms", "samples_per_second", "loss_first",
            "loss_last", "memory", "busy_share", "k4_device_ms")},
             "serve": {tag: {k: v[k] for k in (
                 "median_ms", "samples_per_second", "memory")}
                 for tag, v in bst["serve"].items()},
             "retrieval": {k: bst["retrieval"][k] for k in (
                 "median_seconds", "candidates_per_second", "memory",
                 "chunk")},
             "cover_edge_tc": bst["cover_edge_tc"]["triangles"],
             "seconds": bst["seconds"]},
        a2a={"prefill_ms": {k: a2a["prefill"][k] for k in (
                 "median_a2a_ms", "median_sort_ms")},
             "step_ms": {k: a2a["train"][k] for k in (
                 "median_a2a_step_ms", "median_sort_step_ms")},
             "drop_share_per_slice": a2a["prefill"]["drop_share_per_slice"],
             "drop_share_sort": a2a["prefill"]["drop_share_sort"],
             "k4_device_ms": {t: v["ms"] for t, v in a2a["k4"].items()},
             "memory": a2a["train"]["memory"],
             "psum_ms": a2a["psum"]["ms"],
             "psum_max_rel_err": a2a["psum"]["max_rel_err"],
             "dryrun": {m: {k: a2a["dryrun"][m][k] for k in (
                 "cells", "ok", "seconds")} for m in ("pod", "multipod")},
             "seconds": a2a["seconds"]},
        serve_tc_batch={k: v["median_seconds"]
                        for k, v in stc["batch"].items()},
        serve_tc_graphs_per_second={
            k: {e["batch_size"]: e["graphs_per_s"] for e in v["batched"]}
            for k, v in stc["serve"].items()},
        robust={"approx_seconds": rob["approx"]["seconds"],
                "approx_error_in_stderr": rob["approx"]["error_in_stderr"],
                "deadlines_median_graphs_per_second": {
                    k: v["median_graphs_per_s"]
                    for k, v in rob["deadlines"].items()},
                "chaos": {f: rob["chaos"][f] for f in (
                    "exact", "approx", "rejected", "failed_batches")}},
        distributed={mode: {k: v[k] for k in (
            "median_seconds", "median_run_stages", "launches", "memory",
            "busy_share", "comm")} for mode, v in dist["full"].items()},
        tune={"sweeps": {k: {f: v[f] for f in (
            "winner", "improvement_graphs_per_s", "p50_reduction",
            "seconds")} for k, v in tune["sweeps"].items()},
              "prewarm": {k: {f: v[f] for f in ("plan_hit", "jit_compiles")}
                          for k, v in tune["prewarm"].items()},
              "fresh_first_latency_s": {
                  k: v["first_latency_s"] for k, v in tune["fresh"].items()},
              "seconds": tune["seconds"]},
        audit={"seconds": aud["seconds"],
               "audit_seconds": aud["audit"]["seconds"],
               "findings": aud["audit"]["counts"],
               "prewarm_seconds": aud["prewarm"]["prewarm_seconds"],
               "prewarm_k1_launches": aud["prewarm"]["k1_launches"],
               "host_syncs": {k: v["card_host_syncs"]
                              for k, v in aud["syncs"].items()}},
        seconds=time.perf_counter() - t_all)
    src = "src/repro_torch/kernels/intersect/csrc/intersect.cu"
    k3s, big = stream["k3"], stream["buffer_65536"]
    k3b = big["k3"]
    k3_err = max(max_err_count, k3s["max_abs_err"], k3b["max_abs_err"],
                 *(v["max_abs_err"] for v in dk3.values()))
    kernels = [{
        "name": "intersect_levels",
        "route": "cuda",
        "source": src,
        "replaces": "src/repro/kernels/intersect/intersect.py:79",
        "replaces_function":
            "repro.kernels.intersect.intersect.intersect_pallas",
        "launches": count_launches["intersect_levels"],
        "matches_plain": max(max_err, stc1["max_abs_err"],
                             stc1x["max_abs_err"], tk1["max_abs_err"]) == 0,
        "max_abs_err": max(max_err, stc1["max_abs_err"],
                           stc1x["max_abs_err"], tk1["max_abs_err"]),
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "sample_rows": k1_sample_rows,
        "sample_ms": s_kernel,
        "sample_plain_ms": s_plain,
        "bound_ms": tot["bound_ms"],
        "bound_by": max(bound_by)[1],
        "search_bound_ms": tot["search_bound_ms"],
        "row_bytes_bound_ms": tot["row_bytes_bound_ms"],
        "library_ms": None,
        "path_ms": tot_p["k1"],
        "serve_tc_launches": stc["batch"]["bounded"]["launches"][
            "intersect_levels"],
        "serve_tc_ms": stc1["ms"],
        "serve_tc_host_paced_ms": stc1["host_paced_ms"],
        "serve_tc_plain_ms": stc1["plain_ms"],
        "serve_tc_bound_ms": stc1["bound_ms"],
        "serve_tc_bound_by": stc1["bound_by"],
        "serve_tc_exact_launches": stc["batch"]["exact"]["launches"][
            "intersect_levels"],
        "serve_tc_exact_ms": stc1x["ms"],
        "serve_tc_exact_host_paced_ms": stc1x["host_paced_ms"],
        "serve_tc_exact_plain_ms": stc1x["plain_ms"],
        "serve_tc_exact_bound_ms": stc1x["bound_ms"],
        "robust_launches": rob_k1,
        "tune_launches": {k: v["launches"]["intersect_levels"]
                          for k, v in tune["sweeps"].items()},
        "audit_prewarm_launches": aud["prewarm"]["k1_launches"],
        **{f"tune_winner_{key}": tk1[key] for key in (
            "winner", "launches", "device_ms", "host_paced_ms", "bound_ms",
            "bound_by", "search_bound_ms", "sample_plain_ms",
            "checked_rows", "rows", "rule_paths", "max_abs_err")},
        "shape": f"rmat{scale} plan, {n_buckets} buckets; serve_tc_*: one "
                 f"batch of {SERVE_LANES} lanes of rmat{SERVE_SCALE} on its "
                 f"bounded plan, one launch per bucket over all lanes "
                 f"(serve_tc_exact_*: on its exact plan); robust_launches: "
                 f"phase 9's open-loop runs and its chaos run; "
                 f"tune_launches: phase 11's sweep of each trace; "
                 f"audit_prewarm_launches: phase 12's prewarm of the "
                 f"compile set; "
                 f"tune_winner_*: each launch of one more replay of the "
                 f"rmat12_16_64 winner, timed, bounded and sampled against "
                 f"the plain version",
    }, {
        "name": "intersect_hits",
        "route": "cuda",
        "source": src,
        "replaces": "src/repro/kernels/intersect/intersect.py:211",
        "replaces_function":
            "repro.kernels.intersect.intersect.intersect_pallas_hits",
        "launches": (find_launches["intersect_hits"]
                     + pv_launches["intersect_hits"] + dk2_launches),
        "launches_find": find_launches["intersect_hits"],
        "launches_per_vertex": pv_launches["intersect_hits"],
        "launches_distributed_per_vertex": dk2_launches,
        "matches_plain": max(max_err_hits, stc2["max_abs_err"],
                             dk2["max_abs_err"]) == 0,
        "max_abs_err": max(max_err_hits, stc2["max_abs_err"],
                           dk2["max_abs_err"]),
        "ms": tot_h["ms"],
        "plain_ms": tot_h["plain_ms"],
        "sample_rows": tot_h["sample_rows"],
        "sample_ms": tot_h["sample_ms"],
        "sample_plain_ms": tot_h["sample_plain_ms"],
        "bound_ms": tot_h["bound_ms"],
        "bound_by": max(bound_by_h)[1],
        "search_bound_ms": tot_h["search_bound_ms"],
        "row_bytes_bound_ms": tot_h["row_bytes_bound_ms"],
        "library_ms": None,
        "host_paced_ms": tot_h["host_paced_ms"],
        "host_paced_path_ms": tot_p["k2"],
        "serve_tc_launches": stc["batch"]["per_vertex"]["launches"][
            "intersect_hits"],
        "serve_tc_ms": stc2["ms"],
        "serve_tc_host_paced_ms": stc2["host_paced_ms"],
        "serve_tc_plain_ms": stc2["plain_ms"],
        "serve_tc_bound_ms": stc2["bound_ms"],
        "serve_tc_bound_by": stc2["bound_by"],
        **{f"distributed_per_vertex_{key}": dk2[key] for key in (
            "launches", "ms", "host_paced_ms", "bound_ms", "bound_by",
            "search_bound_ms", "sample_plain_ms", "checked_rows", "rows",
            "cells", "rule_paths", "max_abs_err")},
        "shape": f"rmat{scale} plan, {n_buckets} buckets, "
                 f"{tot_h['launches']} launches at the main path's chunk "
                 f"shapes; serve_tc_*: the per-vertex count of one batch "
                 f"of {SERVE_LANES} lanes of rmat{SERVE_SCALE}, one launch "
                 f"per chunk of the cell budget over all lanes; "
                 f"distributed_per_vertex_*: the per-vertex hedge rounds "
                 f"of Algorithm 2 at rmat{scale} on {DIST_P} shards of the "
                 f"card, each launch of one more run timed, bounded and "
                 f"its mask sampled against the plain version",
    }, {
        "name": "intersect_count",
        "route": "cuda",
        "source": src,
        "replaces": "src/repro/kernels/intersect/intersect.py:148",
        "replaces_function":
            "repro.kernels.intersect.intersect.intersect_pallas_count",
        "launches": stream["launches"]["intersect_count"],
        "launches_one_percent":
            stream["one_percent"]["launches"]["intersect_count"],
        "launches_buffer_65536":
            big["launches"]["intersect_count"],
        "matches_plain": k3_err == 0,
        "max_abs_err": k3_err,
        "ms": k3s["device_ms"]["auto"],
        "host_paced_ms": k3s["host_paced_ms"]["auto"],
        "path_ms": {p: k3s["device_ms"][p] for p in K3_PATHS_TIMED},
        "host_paced_path_ms": {p: k3s["host_paced_ms"][p]
                               for p in K3_PATHS_TIMED},
        "paths": k3s["rule_paths"],
        "plain_ms": k3s["plain_ms"],
        "bound_ms": k3s["bound_ms"],
        "bound_by": k3s["bound_by"],
        "search_bound_ms": k3s["search_bound_ms"],
        "row_bytes_bound_ms": k3s["row_bytes_bound_ms"],
        "library_ms": None,
        "timed_launches": k3s["launches"],
        "timed_rows": k3s["rows"],
        "timed_cells": k3s["cells"],
        "stream_device_ms_per_batch": stream["k3_ms_per_batch"],
        "buffer_65536_timed_launches": k3b["launches"],
        "buffer_65536_ms": k3b["device_ms"]["auto"],
        "buffer_65536_host_paced_ms": k3b["host_paced_ms"]["auto"],
        "buffer_65536_path_ms": {p: k3b["device_ms"][p]
                                 for p in K3_PATHS_TIMED},
        "buffer_65536_host_paced_path_ms": {p: k3b["host_paced_ms"][p]
                                            for p in K3_PATHS_TIMED},
        "buffer_65536_paths": k3b["rule_paths"],
        "buffer_65536_plain_ms": k3b["plain_ms"],
        "buffer_65536_bound_ms": k3b["bound_ms"],
        "full_width_launches": n_buckets,
        "full_width_ms": tot_c["ms"],
        "full_width_host_paced_ms": tot_c["host_paced_ms"],
        "full_width_path_ms": tot_p["k3"],
        "full_width_paths": paths_c,
        "full_width_plain_ms": tot_c["plain_ms"],
        "full_width_bound_ms": tot_c["bound_ms"],
        "full_width_search_bound_ms": tot_c["search_bound_ms"],
        "full_width_bound_by": max(bound_by_c)[1],
        "full_width_row_bytes_bound_ms": tot_c["row_bytes_bound_ms"],
        "full_width_max_abs_err": max_err_count,
        **{f"distributed_{mode}_{key}": v[key] for mode, v in dk3.items()
           for key in ("launches", "device_ms", "host_paced_ms", "bound_ms",
                       "bound_by", "search_bound_ms", "sample_ms",
                       "sample_plain_ms", "checked_rows", "rows",
                       "rule_paths", "max_abs_err")},
        **{f"distributed_{mode}_main_path_launches": v["launches"]
           for mode, v in dist["full"].items()},
        "shape": f"rmat{scale} stream probes: the {k3s['launches']} "
                 f"launches of 8 applies of {STREAM_BATCH} mixed updates "
                 f"(launches: the main path's 8 timed applies), each on "
                 f"the device by the rule and by each path and compared "
                 f"on every row; buffer_65536_*: the {k3b['launches']} "
                 f"launches of one apply of {BIG_BUFFER} at that buffer; "
                 f"full_width_*: the count's plan run level-free, "
                 f"{n_buckets} buckets, one launch each; distributed_*: "
                 f"the hedge rounds of Algorithm 2 at rmat{scale} on "
                 f"{DIST_P} shards of the card (main_path_launches: the "
                 f"warm-up run's; the rest: each launch of one more run, "
                 f"timed, bounded and sampled against the plain version)",
    }, gnn["kernel"], lm["kernel"], lmt["kernel"]]
    print(json.dumps({"kernels": kernels}))
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
