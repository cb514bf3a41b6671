#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpuvsr_torch``) on one
NVIDIA card.

Phases, in order; a failing phase ends the run with a non-zero exit:
  1. build every hand kernel from ``tpuvsr_torch/csrc`` with nvcc
     (sm_90a, one nvcc per source, all at once);
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel of the BFS path against its plain PyTorch version
     on the card, on the largest inputs each one met in an untimed
     recording run of that path (same depth, tile, chunk and 2^26 FPSet
     slots); time kernel, plain version and, where PyTorch computes the
     same function in one call (K2: a torch.sort lexsort), that call;
  4. run the counter stub through DeviceBFS on the card (16 distinct,
     levels [1,2,3,4,3,2,1]; the Bound violation trace);
  5. the BFS path: DeviceBFS.run on examples/VSR_defect.cfg to depth
     10 (tile 128, 64 tiles a chunk, 2^26 FPSet slots; K6 and K7 serve
     its guard matrix and compaction), launch counts reset just before
     and read just after (K18 checks the initial state's invariants);
     the level sizes must be the JAX package's recorded ones; its
     trace-pointer tables are kept for phase 7;
  6. the hunt path (the walker fleet):
     a. an untimed recording pass of the guided defect hunt (its first
        round, kernel by kernel: every round has the same shapes); K5
        (lane choice and swarm noise) held bit for bit against its plain
        version (sim/rng.py) on the largest inputs the pass met, and K1,
        K2 and K3 on the hunt's own batches; each timed; K10 on the
        hunt step's queue widened to MAX_MSGS 448 (a row past 48 KB of
        shared memory) against its plain version; then the same
        round through the CUDA graph of a step that the hunt replays
        must give the same walks bit for bit;
     b. the counter-stub fleet on the card: its Bound violation trace
        must be the JAX package's (STUB_FLEET below);
     c. the guided defect hunt (4096 walkers, depth 40, seed 2,
        max_seconds 600), launch counts reset just before and read just
        after; its trace is replayed through the port's kernel, and
        walks, steps, trace length and actions must be the JAX CPU
        record of the same run (HUNT_RECORD below); K6 and K10 must
        have launched;
     d. one guided round on the shipped model (SYMMETRY symmValues, 64
        walkers, depth 16, seed 2): its digest must be the JAX CPU
        record's (SHIPPED_ROUND), which only a seen-set of canonical
        fingerprints gives;
  7. the fused path (DeviceBFS.run_fused, the CUDA graph of a tile):
     a. an untimed eager recording run_fused to depth 10 (tile 128,
        2^26 FPSet slots) keeps the inputs of the K6, K7 and K8 calls
        that did the most work;
     b. K6 (guard matrix), K7 (work-queue compaction; torch.nonzero is
        its library yardstick) and K8's commit_prefix, commit_finish and
        level_step held bit for bit against their plain versions on
        those inputs, each timed with its bound;
     c. the timed run_fused to depth 10, launch counts reset just before
        and read just after: its levels must be the recorded ones and
        its trace-pointer tables those of phase 5's run(); it prints
        wall time, distinct/s, host reads, tile replays (and those after
        a stop), graph captures, growth pauses, launches and peak
        memory;
     K9 (orbit canonicalization) must launch 0 times in phases 5, 6c
     and 7c: the defect config declares no SYMMETRY;
     K10 (the VSR successors and invariants) is held bit for bit
     against its plain version on the largest work queue of each
     recording pass (7a's fused queue on the defect config, 8a's run()
     queue on the shipped model, 6a's hunt step), on the entries the
     queue filled, and timed (each call after an L2 flush) with its
     bound; the plain version's device
     time per action (its profiler ranges) is kept; in phases 5, 6c,
     7c and 8a-8c K10 must launch and the plain action functions must
     not run at all (models/vsr_kernel.PLAIN_CALLS);
  8. the symmetric model, tpuvsr_torch/configs/VSR_shipped.cfg (the
     reference's shipped VSR.cfg, SYMMETRY symmValues), symmetry on:
     a. an untimed recording run() to depth 12 (tile 128, 64 tiles a
        chunk, 2^26 FPSet slots): its levels must be the record's
        (SHIPPED_LEVELS) and K9 must relabel some rows; K9 held bit for
        bit against its plain version on the largest batch it met, K9's
        images invariant under every group row, K9 and K3 (full, on the
        canonical images) timed; its trace-pointer tables are kept;
     b. the timed run_fused to depth 16, launch counts reset just before
        and read just after: its levels must be the record's and its
        trace-pointer tables through level 12 those of 8a; K9 launched,
        the incremental fingerprint (vsr_fp_parts, vsr_fp_incremental)
        not; it prints what 7c prints and the orbit ratio;
     c. the A/B leg: run_fused with symmetry off to depth 9, its levels
        those of the JAX package's symmetry-off BFS (SHIPPED_OFF_LEVELS);
  9. the paged path (PagedBFS: the frontier in pinned host pages, paged
     through the card a chunk at a time; tile 128, 64 tiles a chunk,
     2^26 FPSet slots, a next buffer of 2^14 rows, so the larger levels
     drain it several times), each run with the launch counts reset just
     before and read just after:
     a. the defect config to depth 10: levels the recorded ones, counts
        and trace-pointer tables those of phase 5's run(), drains of a
        full buffer at least 3; K1-K4, K6, K7 and K10 launched, K9, K11
        and K12 not; it prints wall, drains, host copy time and peak
        memory;
     b. the same with the disk tier (at most 2^16 rows a level in RAM,
        the rest in files under a temporary directory): the same
        results, and the files written and gone at the end;
     c. edges=True (and retain_levels, as the liveness graph runs it;
        edge buffers of 2^15 rows, so that full ones drain mid-chunk) to
        depth 10: levels and trace-pointer tables those of phase 5;
        every destination gid in [0, distinct); each expanded state's
        out-degree its enabled lanes in K6's guard matrix; every
        trace-pointer edge present; the fingerprint-labelled multiset of
        the edges out of levels 0-6 the JAX-kernel host BFS's
        (EDGE_RECORD); K11 and K12 launched and their plain versions run
        0 times; nothing is wrapped in this timed run; then, on the
        same engine, the two-pass graph (device_liveness.two_pass_prefix:
        DeviceGraph's fingerprint index over levels 0-7 by insert_gids,
        and its edge pass over levels 0-6 on K6, K7, K10, K3 and
        lookup_gids), launch counts reset
        just before and read just after: its CSR the streamed one out
        of levels 0-6, K1, K11 and the edge pass's kernels launched, K12
        and the plain versions not;
     d. an untimed recording edge run to depth 10 keeps the largest
        inputs of K11's store, K11's lookup and K12; K11 (store, and its
        probe as lookup_gids and as query_core) and K12 held bit for bit
        against their plain versions on them (on the final table of that
        run), each timed after an L2 flush with its bound;
     e. the behaviour graph of the Ticker stub (DeviceGraph) on the
        card, streamed and two-pass: both CSRs equal the streamed one
        the plain versions give on the CPU, under canon_csr;
     then 19c (below) on 9c's engine;
  10. VR_STATE_TRANSFER (ST03), the first model of the VSR family other
     than VSR (tile 128, 64 tiles a chunk, 2^26 FPSet slots; launch
     counts reset just before each run and read just after, and in each
     run K13, K14 and K3's ST03 kernels launched, the VSR kernels K6,
     K9, K10 and VSR's K3 not, and the plain ST03 guard and action
     functions not at all, models/st03_kernel.PLAIN_CALLS):
     a. an untimed recording run() of tpuvsr_torch/configs/
        VR_STATE_TRANSFER_small.cfg to its fixpoint: 42,753 distinct,
        106,794 generated, diameter 24 (scripts/fixpoints.json) and the
        levels ST03_SMALL_LEVELS; it keeps the largest inputs of K13,
        K14 and K3 (full, parts, incremental);
     b. K13, K14 and K3 on ST03 held bit for bit against their plain
        versions on those inputs, each timed after an L2 flush with its
        bound;
     c. the timed run_fused on the same cfg to its fixpoint: 10a's
        levels, totals and trace-pointer tables; K7 and K8 launched too;
        it prints wall, distinct/s, host reads, graph captures, growth
        pauses and peak memory;
     d. the timed run_fused on tpuvsr_torch/configs/
        VR_STATE_TRANSFER_shipped.cfg to depth 16 and run() to depth
        12: the levels through the JAX record's depth the record's
        (ST03_SHIPPED_LEVELS), and run()'s levels run_fused()'s;
  11. the family's other models, A01 (VR_ASSUME_NEWVIEWCHANGE), I01
     (VR_INC_RESEND) and AS04 (VR_APP_STATE), each on its own
     instantiation of K13, K14 and K3 (tile 128, 64 tiles a chunk, 2^26
     FPSet slots; launch counts reset just before each run and read just
     after, and in each run the model's K13, K14 and K3 launched, the
     other models' kernels, the VSR kernels and the family's plain guard
     and action functions not), in turn:
     a. an untimed recording run() of tpuvsr_torch/configs/
        <module>_small.cfg to its fixpoint (scripts/fixpoints.json: A01
        42,753 / 106,794 / 24, I01 52,635 / 135,162 / 24, AS04 42,738 /
        85,336 / 24) with the levels of FAMILY; it keeps the largest
        inputs of K13, K14 and K3 (full, parts, incremental);
     b. the model's K13, K14 and K3 held bit for bit against their plain
        versions on those inputs, each timed after an L2 flush with its
        bound;
     c. the timed run_fused on the same cfg to its fixpoint: 11a's
        levels, totals and trace-pointer tables; it prints wall,
        distinct/s, host reads, graph captures, growth pauses and peak
        memory;
     d. <module>_shipped.cfg through run_fused to depth 16 and run() to
        depth 12: the levels through depth 8 the JAX record's, run()'s
        levels run_fused()'s;
     e. an untimed recording run() of the shipped constants to the
        model's ``cover_depth`` (A01 and I01 11, AS04 12) that keeps, for
        each action, the K13 and K14 call in which its lanes were enabled
        most; on those inputs K13, K14 (under the cfg's invariants and
        under each of INVARIANT_FNS alone, ReceivedDVCsAllSameView
        included) and K3's full fingerprint of the successors held bit
        for bit against their plain versions, with every action but
        NoProgressChange enabled in them (I01's ResendSVC, AS04's
        SendGetState, ReceiveGetState and ReceiveNewState);
  12. the crash-recovery models, RR05 (VR_REPLICA_RECOVERY) and AL05
     (VR_REPLICA_RECOVERY_ASYNC_LOG), each on its own instantiation of
     K13, K14 and K3 (as in phase 11: launch counts reset just before
     each run and read just after, the model's kernels launched, every
     other model's, the VSR kernels and the plain functions not):
     a. AL05's small cfg with its invariants: an untimed recording run()
        that keeps the largest inputs of K13, K14 and K3, which are then
        held bit for bit against their plain versions and timed; it and
        run_fused() stop at depth 17 on the same NoLogDivergence
        counterexample (RECOVERY's), with the record's levels before it;
        with no invariant, run_fused() reaches the fixpoint (RECOVERY's
        distinct, generated, diameter and levels) and run() depth 18
        (AL05_REACH_RUN_DEPTH) with the record's levels, their
        trace-pointer tables equal through it; K4's range check on the
        recorded queue's successors: the flag stays 0 on them and is set
        by a copy with one lane of any bounded plane past or below its
        bound, on which the plain pack raises;
     b. RR05's small cfg at CrashLimit 0 through both entry points to
        VR_APP_STATE's fixpoint (FAMILY's AS04 record), equal pointers;
     c. RR05's small cfg at CrashLimit 1: a recording run() (K13, K14,
        K3 held against their plain versions as in a) and run_fused()
        stop at depth 17 on the same NoLogDivergence counterexample; the
        levels and cumulative generated counts through depth 16 are the
        JAX host BFS's, those at depths 10, 12, 14 and 15 the JAX log's,
        and the largest recovery nonce first reaches 4 at depth 16; K4's
        range check as in a; with no invariant, run() to depth 22 and
        run_fused() to depth 28 past the counterexample, equal levels
        and trace-pointer tables through 22, the levels through 16 the
        JAX host BFS's, and the largest nonce past 4;
     d. each model's _wide cfg through run_fused() to depth 12 and run()
        to depth 10: the levels through depth 6 the JAX record's, run()'s
        levels run_fused()'s;
     e. a recording run() of each _wide cfg to depth 12: K13, K14 (under
        each invariant alone) and K3 against their plain versions on the
        calls where each action was enabled most, every action but
        NoProgressChange enabled in them;
     f. RR05's small cfg with no invariant, packed under the JAX
        package's manifest (the recovery nonce in 2 bits): run_fused()
        to depth 15 holds, and run_fused() and run() to depth 16, where
        the first nonce of 4 appears, stop on K4's range flag (run()
        after completing depth 15) instead of wrapping it to 0;
  13. the checkpointing model, CP06 (VR_REPLICA_RECOVERY_CP), on its own
     instantiation of K13, K14 and K3 (as in phase 11: launch counts
     reset just before each run and read just after, CP06's kernels
     launched, every other model's, the VSR kernels and the plain
     functions not):
     a. an untimed recording run() of its small cfg to the fixpoint
        (CHECKPOINT: 137,524 distinct, 364,538 generated, diameter 29,
        the record's 29 levels and the JAX host BFS's cumulative
        generated counts), the largest recovery nonce tracked (1, within
        1 + CrashLimit); K13, K14 and K3 held bit for bit against their
        plain versions on its largest inputs and timed, and K13, K14
        (under each invariant alone) and K3 on the calls where each
        action was enabled most (every action but state transfer's,
        which one value cannot open, and NoProgressChange); K4's range
        check as in 12a; the timed run_fused() to the fixpoint with
        run()'s levels, totals and trace-pointer tables;
     b. the _wide cfg through run_fused() to depth 12 and run() to depth
        10: the levels through depth 6 the JAX host BFS's, run()'s
        levels run_fused()'s;
     c. a recording run() of the _wide cfg to depth 12, held as in a
        on the calls where each action was enabled most (every action
        but NoProgressChange, SendSV, ReceiveSV and state transfer's: no
        view change completes by depth 12);
     d. the rows of ``tpuvsr_torch.testing.checkpoint_rows`` in the
        small and wide layouts: K13 on every lane, K14 on every (row,
        lane) item under each invariant mask and K3 held bit for bit
        against their plain versions; on the wide layout SendSV,
        ReceiveSV, state transfer and both reply forms (checkpoint and
        suffix) of ReceiveGetState and ReceiveRecoveryMsg enabled; with
        a, c and d every action but NoProgressChange held in both K13's
        and K14's inputs;
  14. the family with symmetry on: each model on its
     tpuvsr_torch/configs/<module>_{shipped,wide}_symmetry.cfg (the base
     cfg plus SYMMETRY symmValues, Permutations({v1, v2}): a group of
     order 2), on its own K13, K14, K3 (full, on the canonical images)
     and its instantiation of K9 in the model's relabel mode (plain:
     ST03, AS04, AL05; packed entries: A01, I01, RR05; a fixed NoOp:
     CP06); as in phase 11, launch counts reset just before each run and
     read just after: the model's K13, K14, K3 full and K9 launched, its
     incremental K3, the other models' kernels, the VSR kernels and the
     plain functions not; symmetry_perms 2 in each run:
     a. an untimed recording run() to depth 8 (its levels and generated
        counts the record's) keeps the largest K9 call; K9 held bit for
        bit against its plain version (CanonSpec.canonicalize_plain
        through the kernel's _permuted) on it, its images invariant
        under every group row, timed with its bound (a kernels-line row
        a model, naming the model and the mode);
     b. run_fused() to depth 16 (_shipped) or 12 (_wide), run_fused() and
        run() to depth 12 (_shipped) or 10 (_wide): the levels through
        the record's depth those of
        tpuvsr_torch/configs/records/family_symmetry_levels.json (the
        JAX CanonSpec host BFS on the CPU, python
        tests/test_torch_family_symmetry.py record N), run()'s levels,
        generated count and trace-pointer tables run_fused()'s at the
        same depth, and the deeper run_fused()'s tables through run()'s
        depth;
     c. the symmetric cumulative distinct count ``on`` at the depth of
        the unsymmetric run_fused of phase 10d, 11d, 12d or 13b (same
        constants) and that run's ``off``: ceil(off / 2) <= on <= off
        (every orbit has one or two members);
     d. PagedBFS on VR_REPLICA_RECOVERY_CP_wide_symmetry.cfg to depth 10:
        14b's run()'s levels, counts and trace-pointer tables, K9
        launched;
     each run prints its distinct states, seconds, peak memory and
     orbit_ratio;
  15. the per-action commit (DeviceBFS(commit="per-action"): K15's
     action_gate and action_finish around K7, K10, K3, K2, K1 and K4 an
     action), launch counts reset just before each timed run and read
     just after (K15 launched, K8's commit_prefix and commit_finish
     not):
     a. an untimed recording run() to depth 8 keeps K15's largest calls;
        then run() and run_fused() on the defect config to depth 10:
        levels, distinct and generated counts and per-action counters
        those of phases 5 and 7c, the trace-pointer tables through
        level 6 the JAX per-action run's (PER_ACTION_RECORD), and
        run_fused()'s tables run()'s; the walls beside the fused
        commit's;
     b. the shipped model with symmetry on, run_fused() to depth 12 in
        both commits: the same levels (the record's), counts and
        per-action counters;
     c. ST03's small cfg to its fixpoint (42,753 / 106,794 / 24)
        through run_fused();
     d. RR05's small cfg through run_fused(): NoLogDivergence at depth
        17, levels through 16 the record's (whether its trace is the
        fused run's is printed);
     e. PagedBFS(commit="per-action", edges=True) to depth 9: the
        fingerprint-labelled edge multiset that of phase 9c's run out of
        the same levels;
     f. K15 against its plain version on 15a's recorded calls (the
        finish also on a tile's last action), timed with its bound;
  16. DeviceSimulator (one shared key stream, K5's shared layout; one
     CUDA graph a chunk), on the defect config at MAX_MSGS 48, 4096
     walkers, chunks of 32, depth 40, seed 0, launch counts reset just
     before each timed run and read just after (K6, K5 shared and K10
     launched, the fleet's K5 layout not), one host read a chunk:
     a. uniform, dense dispatch: the first chunk run eagerly with every
        K5 call held bit for bit against its plain version; then 4 x
        4096 walks through the graphs, whose first round's (action,
        param) histories must equal an eager run of the plain versions
        on the card;
     b. the same with uniform action weights and swarm noise of sigma
        0.5 (K5's shared noise held against its plain version) and the
        grouped dispatch, against the eager plain dense run;
     c. guided (split_beta 1.5, the hunt's weights, swarm 1.0) for 60
        s: whether it finds AcknowledgedWriteNotLost, and when; a found
        trace must replay (check_replay);
     d. ST03's shipped cfg, one round to depth 30 on K13 and K14, its
        histories those of the eager plain run;
     each prints steps/s and walks/s;
  17. trace validation (validate.BatchValidator: the guard matrix, K16's
     select, the successors and fingerprints, K16's commit a step; the
     queue's size read from the card once a step, the chunk's flags once
     a chunk), launch counts reset just before each timed run
     and read just after (K16's select and commit launched; on VSR K6,
     K10 and the incremental K3 too, and the plain action functions
     not):
     a. the counter stub, parsed by the port's frontend
        (testing.counter_spec), 1024 traces of depth 6 (seed 0) with
        confirm=True: genuine, mutated (trace 11 at event 2), one
        variable dropped and every third event blank; each report equals
        the port's host_validate_batch on the same traces, trace 11
        diverges at event 2 and the others are accepted;
     b. VSR on examples/VSR_defect.cfg at MAX_MSGS 48, a shim spec whose
        only initial state is state 0 of
        examples/found_violation_trace.txt (parsed by the port's
        trace_parse), confirm=False (VSR's .tla is not in the
        repository): the golden trace, actions observed only, is
        accepted with the plain version's candidate-set sizes by event
        (GOLDEN_SIZES; cand_cap grown to 256); a mutant with
        ReceivePrepareOkMsg inserted before event 1 diverges there with
        2 candidates and {ReceiveClientRequest, ReceiveHigherSVC,
        TimerSendSVC} enabled; then 1024 walks of DeviceSimulator
        (1024 walkers, seed 0, depth 12: cut from 40, see VALIDATE; 16
        of them re-executed by materialize_walk), actions
        observed only, rounds of 32 traces: every one accepted; each
        prints traces/s, events/s, the final cand_cap and the
        message-table size;
     c. K16's select and commit held bit for bit against their plain
        versions on the card on the call with the most queue items of
        a's mutated run and of an untimed recording round of b's walks
        (candidate rows, alive, div_at, div_en, div_cand, the chunk's
        counts), each timed with its bound; each row's launches are
        those of the timed run it was recorded from;
  18. speclint's facts and the ample-set partial-order reduction (K17:
     por_cand, por_probe, por_keep), each run with the launch counts
     reset just before and read just after (K17 launched in every run
     with a live reduction, never in one without):
     a. the stub oracles through run(), run_fused() and PagedBFS: the
        counter with an invariant that reads neither counter
        (counter_spec(inv_free=True)) and check_deadlock, POR on: 7
        distinct, levels [1]*7, kept/full 6/9, a deadlock at (3, 3); POR
        off: 16, [1,2,3,4,3,2,1], the same deadlock; SymPair parsed,
        symmetry off, POR on: 13, [1, 3, 9]; counter_spec(inv_x_bound=2)
        at tile 4, POR on: Bound with the trace the port's CPU run gives;
        the default Bound: POR inert, bit-identical to off (generated
        included); bounds on against off (the dead-action fixture with
        Bound x + y <= 3): bit-identical, Jump pruned, 6 bits a state
        against the declared 8;
     b. at scale: the inv_free counter at Limit POR["limit"] (2047:
        4,194,304 states unreduced), check_deadlock, through run_fused()
        with POR off and on, and run() with POR on at POR["run_limit"]
        (1023): the deadlock at (Limit, Limit), the reduced runs 2 *
        Limit + 1 distinct in as many levels (4,095 and 2,047); each
        prints distinct, generated, kept/full, amp and seconds;
     c. K17 held bit for bit against its plain versions, stage by stage,
        on the inputs of the largest tile of a's run() (the stub's
        shape) and on a stress shape made on the card (8,192 rows x 64
        actions with ineligible all-False rows, a queue of 65,536 items,
        a 2^22-slot table half full, markers over pdepth-2..pdepth+1
        and -1, half the queue present), each timed with its bound; the
        stub rows' launches are a's run()'s, the stress rows' b's
        run_fused() with POR on;
     d. the defect and shipped bindings (cfg-only) resolve bounds and
        POR to None and preflight runs no pass on them, so phases 5-9
        ran as before;
  19. liveness (engine/liveness.liveness_check over the device-built
     behaviour graph) and K18, the state predicates (``state_predicates``
     of VSRKernel and of the ST03 family's kernels: csrc/vsr_actions.cu
     and csrc/st03_actions.cu, St::invariants one bit at a time, the
     code K10 and K14 run on successors); every engine checks its
     initial states' invariants with one K18 launch (phase 5 requires
     it), and a reported violation's rebuilt state with another:
     a. the Ticker stub, parsed (testing.ticker_spec, modulus 6), in five
        cases (FairSpec and Spec with []<>AtZero, FairSpec with AtZero ~>
        Hit, the stop-free FairSpec with each property) through
        DeviceGraph on the card in both modes: verdict, property name,
        lasso (actions and states) and cycle start those of
        liveness_check on the interpreter's graph;
     b. A01's small cfg through PagedBFS(retain_levels=True, edges=True)
        to its fixpoint (42,753 / 106,794 / 24, FAMILY's levels), the
        engine handed to DeviceGraph; its streamed CSR out of levels 0-7
        that of two_pass_prefix(engine, 8) under canon_csr;
        batch_predicate for every name of A01's INVARIANT_FNS over every
        state (one K18 launch a name and level block), K18 with every
        bit held bit for bit against its plain version over every
        state, the states on which each holds printed
        (AllReplicasMoveToSameView false on some); a kernels-line row
        at the fixpoint's shape;
     c. (run in phase 9, before 9c's engine is freed) K18 with VSR's five
        bits over the levels 9c retains (the ten it expanded, 148,897
        states, in batches of 2^16 rows as DeviceGraph moves them), bit
        for bit against its plain version; a kernels-line row at one
        batch, its launches phase 5's;
     d. (run in phases 10-13) on every K14 queue that
        check_st03_kernels and check_family_coverage hold (10b, 11b,
        11e, 12a, 12c, 12e, 13a, 13c), K18 with every bit on K14's
        successor rows, each bit equal to K14's iok under that
        invariant alone and the whole to K18's plain version: all seven
        family instantiations launch; phase 19 requires every one;
  then print the kernels line, and the result line last.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Options:
``--out FILE`` writes the measurements as JSON, ``--profile`` adds a
torch.profiler table of a depth-7 BFS run, of one steady round of the
hunt, of one quantum of each fused path (phases 7 and 8) and of a
depth-9 paged edge run (phase 9) to that file; ``--depth N`` changes
the defect config's BFS depth in phases 3, 5 and 7 (10 by default).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
SHIPPED = os.path.join(ROOT, "tpuvsr_torch", "configs", "VSR_shipped.cfg")
LEVELS = [1, 5, 18, 62, 226, 833, 2950, 10048, 32805, 101949, 299683]
# the shipped model with symmetry on: levels 0-10 from the JAX package's
# CanonSpec level BFS on the CPU (python tests/test_torch_symmetry_bfs.py
# 10), 11-16 from the JAX package's at-scale record
# scripts/shipped_pin.json (level_sizes_tail; its distinct_states less
# the tail is the sum of levels 0-10)
SHIPPED_LEVELS = [1, 3, 10, 35, 124, 403, 1200, 3319, 8500, 20030, 43306,
                  86415, 161457, 287614, 496278, 838162, 1393641]
SHIPPED_OFF_LEVELS = [1, 4, 14, 48, 168, 558, 1713, 4877, 12868, 31370]
SYM = {"record_depth": 12, "depth": 16, "off_depth": 9}
STUB_TRACE = [(None, {"x": 0, "y": 0}), ("IncY", {"x": 0, "y": 1}),
              ("IncY", {"x": 0, "y": 2}), ("IncX", {"x": 1, "y": 2}),
              ("IncX", {"x": 2, "y": 2}), ("IncX", {"x": 3, "y": 2})]
# tpuvsr.testing.stub_fleet(walkers=64, inv_x_bound=2).run(num=1024,
# depth=8, seed=7) on the CPU (python tests/test_torch_fleet.py stub)
STUB_FLEET = {"violated": "Bound", "walks": 64, "steps": 307,
              "trace": [[None, 0, 0], ["IncY", 0, 1], ["IncX", 1, 1],
                        ["IncY", 1, 2], ["IncY", 1, 3], ["IncX", 2, 3],
                        ["IncX", 3, 3]]}
HUNT = {"walkers": 4096, "depth": 40, "max_seconds": 600.0, "sigma": 1.0,
        "mode": "guided"}
# the JAX package's guided hunt on the CPU, same walkers and depth, seed
# 2 (python tests/test_torch_fleet.py hunt 4096 40 2, about half an hour
# on 8 CPU cores): the violation on walk 728,342 of round 178, step 30
HUNT_RECORD = {2: {
    "ok": False, "violated": "AcknowledgedWriteNotLost", "walks": 729088,
    "steps": 25253786, "trace_len": 31, "walk": 728342,
    "actions": [
        "ReceiveClientRequest", "TimerSendSVC", "ReceivePrepareMsg",
        "ReceivePrepareOkMsg", "TimerSendSVC", "ExecuteOp",
        "ReceiveClientRequest", "ReceiveHigherSVC",
        "ReceiveHigherSVC", "SendDVC", "ReceiveMatchingDVC",
        "ReceiveMatchingSVC", "SendDVC", "SendSV",
        "ReceiveClientRequest", "SendGetState", "TimerSendSVC",
        "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
        "ReceiveHigherSVC", "SendDVC", "SendDVC",
        "ReceiveMatchingSVC", "ReceiveMatchingSVC",
        "ReceiveMatchingSVC", "ReceiveMatchingDVC", "SendSV",
        "ReceiveSV", "ReceiveSV"]}}
# the JAX package's guided round on the shipped model on the CPU: 64
# walkers, depth 16, seed 2, the hunt's parameters, symmetry auto
# (python tests/test_torch_fleet.py shipped; digests of its int32 event
# arrays and histories and of the splitter's float64 novelty)
SHIPPED_ROUND = {"steps": 1024, "chunks": 2, "events": "9f56cda75fefeab9",
                 "hists": "456ecaa59e53392b", "fresh": 61,
                 "novelty": "e31bedb0d9a84d33"}
# the fingerprint-labelled edge multiset of the defect config out of
# levels 0-6 (4,095 states), from a host BFS over the JAX package's
# VSRKernel on the CPU (python tests/test_torch_edges.py record 7)
EDGE_RECORD = {"depth": 7, "sources": 4095, "edges": 28898,
               "digest": "d5d297c814652145"}
ST03_SMALL = os.path.join(ROOT, "tpuvsr_torch", "configs",
                          "VR_STATE_TRANSFER_small.cfg")
ST03_SHIPPED = os.path.join(ROOT, "tpuvsr_torch", "configs",
                            "VR_STATE_TRANSFER_shipped.cfg")
# VR_STATE_TRANSFER_small.cfg to its fixpoint: the totals
# scripts/fixpoints.json records for 03-state-transfer/VR_STATE_TRANSFER
# (the interpreter's, from the spec's own Init), and the levels of the
# JAX package's ST03Kernel in a host BFS from ST03Codec.init_dense on the
# CPU (python tests/test_torch_st03_bfs.py small 24, whose 25th level,
# 0, is the fixpoint)
ST03_SMALL_LEVELS = [1, 3, 8, 24, 68, 163, 332, 595, 968, 1457, 2027, 2613,
                     3261, 4153, 5265, 6086, 5970, 4755, 2974, 1412, 487,
                     114, 16, 1]
ST03_FIXPOINT = (42753, 106794, 24)
# VR_STATE_TRANSFER_shipped.cfg: the same host BFS's levels (python
# tests/test_torch_st03_bfs.py shipped 11, 198 s on 8 CPU cores)
ST03_SHIPPED_LEVELS = [1, 4, 17, 63, 238, 851, 2814, 8564, 24012, 62231,
                       149418, 333593]
# phase 10d's depths: run_fused takes 10-60 s to depth 16 on the card;
# run(), host-bound (a host read a tile), took 65 s to 14 (PERF.md §4)
# and runs to 12 (run_fused keeps 16 and the record; run()'s levels are
# still held to run_fused()'s through its depth)
ST03_SHIPPED_DEPTH = 16
ST03_SHIPPED_RUN_DEPTH = 12
# phase 11: the family's other models.  The small cfgs' fixpoints are
# scripts/fixpoints.json's (distinct, generated, diameter); the levels,
# small and shipped, are those of a host-driven level BFS over the JAX
# package's kernel from init_dense on the CPU (as ST03's above; the
# shipped ones through depth 8, at MAX_MSGS 48; tests/test_torch_a01.py
# holds the port's CPU runs to depths 8 and 5 against the same BFS)
FAMILY = {
    "A01": {
        "module": "VR_ASSUME_NEWVIEWCHANGE",
        "fixpoint": (42753, 106794, 24),
        "small": [1, 3, 8, 24, 68, 163, 332, 595, 968, 1457, 2027, 2613,
                  3261, 4153, 5265, 6086, 5970, 4755, 2974, 1412, 487, 114,
                  16, 1],
        "shipped": [1, 4, 16, 56, 198, 667, 2108, 6262, 17487],
        "cover_depth": 11},
    "I01": {
        "module": "VR_INC_RESEND",
        "fixpoint": (52635, 135162, 24),
        "small": [1, 3, 8, 24, 68, 163, 332, 595, 968, 1457, 2043, 2701,
                  3481, 4563, 5997, 7324, 7718, 6705, 4653, 2499, 999, 280,
                  49, 4],
        "shipped": [1, 4, 15, 47, 143, 401, 1056, 2672, 6721],
        "cover_depth": 11},
    "AS04": {
        "module": "VR_APP_STATE",
        "fixpoint": (42738, 85336, 24),
        "small": [1, 3, 8, 24, 68, 162, 331, 593, 965, 1453, 2024, 2612,
                  3261, 4153, 5265, 6086, 5970, 4755, 2974, 1412, 487, 114,
                  16, 1],
        "shipped": [1, 4, 17, 63, 238, 850, 2809, 8538, 23908],
        "cover_depth": 12},
}
# phase 11d's depths: run_fused (2-4 s to depth 14 on the card), and
# run() (a host sync a tile; 1.5-4.2 s to depth 11; 7.5-36.2 s to 13,
# PERF.md §4, so 12, run_fused keeping 16).  ``cover_depth``
# is phase 11e's: the shallowest at which every action but
# NoProgressChange is enabled on the shipped constants (I01's ResendSVC
# by depth 6; AS04's ReceiveNewState first at depth 12, 4 lanes)
FAMILY_FUSED_DEPTH = 16
FAMILY_RUN_DEPTH = 12
# phase 12: the crash-recovery models at CrashLimit 1.  The records are
# those of a host-driven level BFS over the JAX package's kernel from
# init_dense (exact: dense states, no pack): RR05's levels through depth
# 16 and cumulative generated counts (Init counted, as the engines count
# it) print with python tests/test_torch_rr05.py record 1 16 (about 4
# min of CPU); AL05's fixpoint, with no invariant, with python
# tests/test_torch_al05.py record 30 (48 min of CPU).  The JAX package's
# own records differ (ROADMAP queue 3): its AL05 fixpoint
# (scripts/recovery_fixpoints.json, 2,316,959 / 5,123,247 / 30) departs
# from the exact levels at depth 16, and RR05's bounded run packs
# the recovery nonce in 2 bits, whose first value of 4 appears at depth
# 16, so scripts/recovery_fixpoints.log's counts (the last line of each
# depth, cumulative) hold through depth 15 and are checked there.  Both
# small cfgs stop at depth 17 on the same NoLogDivergence counterexample
# (COUNTEREXAMPLE); with CrashLimit 0 RR05 is VR_APP_STATE (FAMILY's AS04
# record).  The wide cfgs' levels: record wide 6 of the same scripts.
# The actions of the counterexample: replica 2 crashes and recovers in
# view 1 (lnv 1 from the response) while replica 1, keeping Init's lnv
# 0, commits v1; in view 2 replica 2's empty-log DoViewChange wins
# HighestLog and SendSV installs commit 1 over an empty log.  The JAX
# kernel's own steps reach the same state (tests/test_torch_a01.py
# check_counterexample).
COUNTEREXAMPLE = [
    "Crash", "ReceiveRecoveryMsg", "ReceiveRecoveryMsg",
    "ReceiveClientRequest", "ReceivePrepareMsg", "TimerSendSVC",
    "ReceivePrepareOkMsg", "PrimaryExecuteOp", "ReceiveHigherSVC", "SendDVC",
    "ReceiveRecoveryResponseMsg", "ReceiveRecoveryResponseMsg",
    "CompleteRecovery", "ReceiveHigherSVC", "ReceiveMatchingDVC", "SendDVC",
    "SendSV"]
RECOVERY = {
    "AL05": {
        "module": "VR_REPLICA_RECOVERY_ASYNC_LOG",
        "fixpoint": (2298063, 5089047, 30),
        "small": [1, 6, 24, 85, 261, 702, 1665, 3509, 6611, 11281, 17722,
                  26123, 37156, 52996, 78044, 117425, 172219, 233786,
                  284323, 306053, 291401, 245792, 183206, 119181, 65855,
                  29600, 10185, 2463, 364, 24],
        "violation": ("NoLogDivergence", 17, COUNTEREXAMPLE),
        "wide": [1, 7, 37, 171, 697, 2604, 9039]},
    "RR05": {
        "module": "VR_REPLICA_RECOVERY",
        "small": [1, 6, 23, 77, 227, 593, 1364, 2761, 4946, 8006, 12065,
                  17434, 24799, 35496, 51609, 75117, 105791],
        "generated": [1, 7, 38, 152, 536, 1665, 4505, 10653, 22241, 41676,
                      71353, 113693, 171708, 250626, 360271, 516245,
                      735948],
        # scripts/recovery_fixpoints.log, the last line of each depth
        "log": {10: (30069, 71353), 12: (72302, 171708),
                14: (159407, 360271), 15: (234524, 516245)},
        "nonce4_depth": 16,
        "violation": ("NoLogDivergence", 17, COUNTEREXAMPLE),
        "wide": [1, 7, 35, 151, 595, 2178, 7426]},
}
RECOVERY_DEPTH = 30          # 12c: RR05, CrashLimit 1 (it stops at 17)
# 12c with no invariant, past the counterexample: the nonce keeps growing
RECOVERY_DEEP = {"fused": 28, "run": 22}
# 12a with no invariant: run_fused() to AL05's fixpoint; run(), host-bound
# (41.7-63.5 s to the fixpoint, PERF.md §4), to depth 18, its levels the
# record's and its pointer tables run_fused()'s through 18
AL05_REACH_RUN_DEPTH = 18
# 12d (run_fused peaks 11.5 / 20.9 GB at depth 12) and 12e (state
# transfer's receives first fire past depth 10)
RECOVERY_WIDE = {"fused": 12, "run": 10, "cover": 12}
# phase 13: VR_REPLICA_RECOVERY_CP (CP06) at CrashLimit 1.  Its small
# cfg's fixpoint is scripts/recovery_fixpoints.json's (the interpreter's,
# the single and the sharded JAX engines': 137,524 distinct, 364,538
# generated, diameter 29, no invariant violated), whose levels a
# host-driven level BFS over the JAX package's kernel from init_dense
# gives too, with these cumulative generated counts (Init counted) and
# the largest recovery nonce 1 at every depth (python
# tests/test_torch_cp06.py record 30, 393 s of CPU; its output is
# tpuvsr_torch/configs/records/CP06_small_host_bfs.log); the wide cfg's
# levels through depth 6 with ... wide 6 of the same script
CHECKPOINT = {
    "module": "VR_REPLICA_RECOVERY_CP",
    "fixpoint": (137524, 364538, 29),
    "small": [1, 6, 23, 68, 181, 426, 879, 1605, 2661, 4083, 5790, 7569,
              9153, 10251, 10588, 10167, 9724, 10158, 11207, 11249, 9305,
              6494, 4662, 4072, 3526, 2336, 1036, 272, 32],
    "generated": [1, 7, 38, 146, 463, 1278, 3064, 6463, 12258, 21450,
                  35026, 53502, 76514, 102741, 130256, 157267, 183283,
                  210652, 242636, 277910, 309509, 331554, 344520, 352592,
                  358412, 362206, 363974, 364474, 364538],
    "nonce": 1,
    "wide": [1, 7, 35, 140, 510, 1693, 5157]}
# 13b's depths and 13c's recording depth: by 12 every action of the wide
# cfg is enabled but SendSV, ReceiveSV and state transfer's (a view
# change completes only once two replicas have committed; a probe of the
# enabled lanes by depth on the card, through depth 12, found none of
# them), which 13d holds on built rows
CHECKPOINT_WIDE = {"fused": 12, "run": 10, "cover": 12}
# phase 14: the family with symmetry on.  The levels and cumulative
# generated counts (Init counted) are the JAX package's CanonSpec host BFS
# on the CPU (python tests/test_torch_family_symmetry.py record N, each
# model to the deepest level that ends in about five minutes), read from
# the record file (chip_smoke imports no JAX)
FAMILY_SYMMETRY = {
    "ST03": ("VR_STATE_TRANSFER", "shipped"),
    "A01": ("VR_ASSUME_NEWVIEWCHANGE", "shipped"),
    "I01": ("VR_INC_RESEND", "shipped"),
    "AS04": ("VR_APP_STATE", "shipped"),
    "RR05": ("VR_REPLICA_RECOVERY", "wide"),
    "AL05": ("VR_REPLICA_RECOVERY_ASYNC_LOG", "wide"),
    "CP06": ("VR_REPLICA_RECOVERY_CP", "wide")}
FAMILY_SYMMETRY_RECORD = os.path.join(
    ROOT, "tpuvsr_torch", "configs", "records",
    "family_symmetry_levels.json")
# 14b's depths (the fused ones those of the unsymmetric runs 14c reads:
# 10d and 11d for the shipped constants, 12d and 13b for the wide), and
# 14a's recording depth
SYMMETRY_DEPTHS = {"shipped": {"fused": 16, "run": 12},
                   "wide": {"fused": 12, "run": 10}}
SYMMETRY_RECORD_DEPTH = 8
SYMMETRY_PAGED = ("CP06", 10)
PAGED = {"next_capacity": 1 << 14, "spill_ram_rows": 1 << 16,
         "edge_capacity": 1 << 15, "min_drains": 3}
# phase 15: the per-action commit.  PER_ACTION_RECORD holds the JAX
# package's per-action and fused runs of the defect config at tile 128,
# 64 tiles a chunk, to depth 6, on the CPU (python
# tests/test_torch_per_action.py record, about five minutes): the
# digests of their trace-pointer tables, which differ where an action's
# batch holds equal successors (the JAX insert names the last of them
# fresh, the fused commit's dedup the first)
PER_ACTION = {"record_depth": 8, "shipped_depth": 12,
              "paged_depth": 9, "recovery_depth": 30}
PER_ACTION_RECORD = os.path.join(ROOT, "tpuvsr_torch", "configs",
                                 "records", "per_action_defect.json")
# and each commit's first counterexample of RR05's small cfg at tile 128:
# a host BFS over the JAX package's kernel in the engines' order
# (python tests/test_torch_rr05.py record-counterexamples), whose fused
# steps are COUNTEREXAMPLE
RR05_COUNTEREXAMPLES = os.path.join(ROOT, "tpuvsr_torch", "configs",
                                    "records", "rr05_counterexamples.json")
# phase 16: DeviceSimulator on the defect config (MAX_MSGS 48) and on
# ST03's shipped cfg; the walks are held against an eager run of the
# plain versions on the card (the JAX package's are held on the CPU at
# small sizes, tests/test_torch_device_sim.py)
SIM = {"walkers": 4096, "chunk": 32, "depth": 40, "seed": 0, "rounds": 4,
       "max_msgs": 48, "sigma": 0.5, "guided_s": 60.0, "guided_sigma": 1.0,
       "st03_depth": 30}
MEM_RATE = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
OPS_RATE = 67e12             # H100 SXM float32 outside the tensor cores


class SmokeError(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def device_events(prof, skip=None):
    """The device activities (kernels, copies, memsets) of a
    torch.profiler trace: the device-side events only, since a CPU op's
    device time repeats that of the kernels it launched, and no
    profiler range (its span on the device timeline includes idle gaps);
    events whose name starts with ``skip`` are left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and not (skip and e.name.startswith(skip))]


def device_us(prof, skip=None):
    """Microseconds of device activity in a torch.profiler trace (the
    events of ``device_events``)."""
    return sum(e.device_time_total for e in device_events(prof, skip))


def same_pointers(got, want, levels, what, args):
    """Fail unless two runs' trace-pointer tables (parent, action, lane)
    are equal; on a difference, say where it starts and whether each
    level holds the same entries in another order, and keep both tables
    beside ``--out``."""
    import numpy as np
    n = min(len(got[0]), len(want[0]))
    if all(np.array_equal(a[:n], b[:n]) for a, b in zip(got, want)) \
            and len(got[0]) >= n:
        return
    diff = np.zeros(n, bool)
    for a, b in zip(got, want):
        diff |= a[:n] != b[:n]
    first = int(np.argmax(diff)) if diff.any() else n
    ends = np.cumsum(levels)
    lvl = int(np.searchsorted(ends, first, side="right"))
    lo = int(ends[lvl - 1]) if lvl else 0
    hi = min(int(ends[lvl]) if lvl < len(ends) else n, n)
    perm = (sorted(zip(*(t[lo:hi] for t in got)))
            == sorted(zip(*(t[lo:hi] for t in want))))
    if args.out:
        np.savez(os.path.join(os.path.dirname(os.path.abspath(args.out)),
                              what.replace(" ", "_") + "_pointers.npz"),
                 got_parent=got[0], got_action=got[1], got_param=got[2],
                 want_parent=want[0], want_action=want[1],
                 want_param=want[2])
    raise SmokeError(
        f"{what} trace-pointer tables differ from run()'s: {int(diff.sum())}"
        f" of {n} entries, the first at {first} (level {lvl}, entries "
        f"{lo}..{hi}); that level holds the same entries in another "
        f"order: {perm}; lengths {len(got[0])} and {len(want[0])}")


def cuda_ms(fn, reps=20, warm=3, evict=None, pre=None):
    """(device ms, issue ms, timed_by) of one fn() call: the device time
    is the sum of the kernels, copies and memsets torch.profiler records
    over ``reps`` calls; the issue time is CUDA events around the same
    calls back to back, which the host's launch rate bounds when the
    kernels are short.  ``pre()``, when given, runs before each call and
    makes device-to-device copies only (a carry restored); with
    ``evict`` (``l2_evict()``) a copy that flushes the 50 MB L2 comes
    before each call too, so that fn reads its inputs from HBM.  All
    such copies are left out of the device time (the issue time keeps
    them), so fn must make none of its own.  The profiler's record is
    taken only where it is whole (``profiled_ms``); the profiled calls
    are made again once where it is not.  After a second miss the
    device time is that of CUDA events around one replay of a CUDA graph
    of ``reps`` calls, less that of a graph of the copies alone (no host
    time in either), and ``timed_by`` says "cuda_graph"; where fn cannot
    be captured (it syncs), CUDA events around ``reps`` calls back to
    back, less the copies alone ("cuda_events": the host's launch rate
    bounds it).  ``timed_by`` is "torch.profiler" otherwise.
    """
    import torch
    steps = ([lambda: evict[0].copy_(evict[1])] if evict is not None
             else []) + ([pre] if pre is not None else [])

    def copies():
        for s in steps:
            s()

    def call():
        copies()
        fn()

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)

    def events_ms(f):
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            f()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    for _ in range(warm):
        call()
    issue = events_ms(call) / reps
    skip = "Memcpy DtoD" if steps else None
    seen = []
    for _attempt in range(2):
        ms, counts = profiled_ms(call, reps, skip)
        if ms is not None:
            return ms, issue, "torch.profiler"
        seen.append(counts)
    try:
        ms, how = (graph_ms(call, reps) - (graph_ms(copies, reps)
                                           if steps else 0.0),
                   "cuda_graph")
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"  (no CUDA graph: {str(e).splitlines()[0]})", flush=True)
        ms, how = (events_ms(call) - (events_ms(copies) if steps else 0.0),
                   "cuda_events")
    ms /= reps
    print(f"  (torch.profiler's record was not whole twice: (one call, "
          f"{reps} calls) {seen} device activities; timed by {how}, "
          f"{ms:.4f} ms a call)", flush=True)
    return ms, issue, how


PROFILE_MARK = "spin_kernel"        # torch.cuda._sleep's kernel


def profiled_ms(call, reps, skip):
    """(device ms a call or None, (activities of one call, of ``reps``
    calls)) from one torch.profiler session of a call, a marker kernel,
    one call, a marker and ``reps`` calls.  The trace may lose a few of
    its first activities, which the first call absorbs.  The ``reps``
    calls after the second marker are timed only where they hold
    ``reps`` times the activities between the markers (one call's), so
    that a record that lost some calls gives no per-call time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda._sleep(100)
        call()
        torch.cuda._sleep(100)
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    evs = sorted(device_events(prof, skip), key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(evs) if PROFILE_MARK in e.name]
    if len(marks) != 2:
        return None, (None, len(evs))
    one, timed = marks[1] - marks[0] - 1, evs[marks[1] + 1:]
    if one == 0 or len(timed) != reps * one:
        return None, (one, len(timed))
    return sum(e.device_time_total for e in timed) / reps / 1e3, None


def graph_ms(f, reps):
    """Milliseconds of one replay of a CUDA graph of ``reps`` f() calls,
    by CUDA events (the device's time alone); RuntimeError where f
    cannot be captured.  Captured through kernels.capture, as hand
    kernels must be (its replays count their launches, as any timing
    call's do; the main-path runs reset the counts first)."""
    import torch
    from tpuvsr_torch import kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        f()
    torch.cuda.current_stream().wait_stream(side)

    def body():
        for _ in range(reps):
            f()
    replay = kernels.capture(body)
    replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def bound(nbytes, nops):
    t_b, t_o = nbytes / MEM_RATE * 1e3, nops / OPS_RATE * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def lexsort_keep(fps, mask):
    """The queue-order first-occurrence keep mask of K2 from torch.sort:
    masked lanes take the all-ones key (as in the JAX lexsort), two
    stable sorts of 64-bit keys group equal keys with the lower lane
    first, and a valid lane is kept where its fingerprint differs from
    the one sorted before it (the JAX rule, masked neighbours included)."""
    import torch
    k = torch.where(mask[:, None], fps, -1).to(torch.int64) & 0xFFFFFFFF
    hi = ((k[:, 0] - 2**31) << 32) | k[:, 1]   # signed order = unsigned
    lo = ((k[:, 2] - 2**31) << 32) | k[:, 3]
    _, perm = torch.sort(lo, stable=True)
    _, p2 = torch.sort(hi[perm], stable=True)
    perm = perm[p2]
    sf = fps[perm]
    first = torch.ones_like(mask)
    first[1:] = (sf[1:] != sf[:-1]).any(dim=1)
    keep = torch.zeros_like(mask)
    keep[perm] = first & mask[perm]
    return keep


def plain_calls():
    """Calls of the plain action functions so far (their one door,
    VSRKernel._action_fns)."""
    from tpuvsr_torch.models.vsr_kernel import PLAIN_CALLS
    return PLAIN_CALLS["actions"]


def k10_only(counts, before, what):
    """K10 launched on a path and the plain action functions did not
    run there."""
    need(counts["vsr_actions"] > 0, f"K10 was not launched on {what}")
    need(plain_calls() == before, f"the plain action functions ran "
         f"{plain_calls() - before} times on {what}")


def record_actions(rec):
    """Keep, in ``rec``, the inputs of the K10 call of the BFS engine
    with the most filled queue entries (the queue's ok column), skipping
    halted calls; returns the uninstall function."""
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    succ = DeviceBFS._successors

    def p_succ(self, flat, q, segs, out=None, halt=None):
        if hasattr(self.kern, "successors") and not (
                halt is not None and bool(halt[0])):
            size = int(q["ok"].sum())
            if size > rec.calls.get("vsr_actions", (-1, None))[0]:
                rec.calls["vsr_actions"] = (size, (
                    self.kern, flat.clone(), q["pidx"].clone(),
                    q["aid"].clone(), q["lane"].clone(), self._inv_mask,
                    q["ok"].clone()))
        return succ(self, flat, q, segs, out, halt)
    DeviceBFS._successors = p_succ

    def uninstall():
        DeviceBFS._successors = succ
    return uninstall


def range_ms(prof, names):
    """Device ms under each action's profiler range in a trace (the
    plain action code's ranges, named ``names``: the kernels each action
    launched)."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            per[e.name] = per.get(e.name, 0.0) + e.device_time_total / 1e3
    return per


def action_profile(fn, names):
    """Device ms of each action's profiler range in one ``fn()`` call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return range_ms(prof, names)


def check_actions(out, call, label=None, name="vsr_actions"):
    """K10 (K14 with ``name`` "st03_actions") bit for bit against its
    plain version on a recorded work queue (the entries the queue
    filled), timed with its bound, and the plain version's device time
    per action."""
    import torch
    kern, flat, pidx, aid, lane, mask, ok = call
    n, lanes = pidx.shape[0], flat.shape[1]
    if ok is None:
        ok = torch.ones((n,), dtype=torch.bool, device=flat.device)
    a = kern.successors(flat, pidx, aid, lane, mask)
    p = kern.successors_plain(flat, pidx, aid, lane, mask)
    torch.cuda.synchronize()
    err = max(max_abs(a[k][ok], p[k][ok]) for k in a)
    buf = kern.successor_buffers(n, flat.device)
    # the queue's parents and outputs (up to 14 MB) would stay in L2
    # from one call to the next: each call starts from an evicted L2
    ms = cuda_ms(lambda: kern.successors(flat, pidx, aid, lane, mask, buf),
                 evict=l2_evict(flat.device))
    plain = lambda: kern.successors_plain(flat, pidx, aid, lane, mask)
    plain_ms = cuda_ms(plain, reps=3, warm=1)
    per_action = action_profile(plain, kern.action_names)
    parents = int(torch.unique(pidx).numel())
    # each parent row read once, each successor row written once, the
    # queue's three int32 columns in, the small outputs out
    nbytes = (parents + n) * lanes * 4 + n * 12 + n * (4 * (kern.R + 1)
                                                      + 3 * 4 + 2)
    kernel_row(out, name, ms, plain_ms, err, nbytes, 0,
               extra={"shape": [n, lanes], "filled": int(ok.sum()),
                      "parents": parents, "max_msgs": kern.M,
                      "enabled": int(a["en2"][ok].sum()),
                      "plain_action_ms": per_action}, label=label)
    print(f"    plain version by action (device ms): "
          f"{ {k: round(v, 4) for k, v in per_action.items()} }",
          flush=True)


def max_abs(a, b):
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


class Recorder:
    """Keeps the inputs of the largest call of each wrapper during a
    run (cloned, so later in-place updates do not reach them)."""

    def __init__(self):
        self.calls = {}

    def keep(self, name, size, make):
        if size > self.calls.get(name, (-1, None))[0]:
            self.calls[name] = (size, make())

    def install(self):
        import torch
        from tpuvsr_torch.engine import device_bfs as D
        from tpuvsr_torch.engine.pack import PackSpec
        from tpuvsr_torch.models.vsr_kernel import VSRKernel
        rec = self
        ins, ded = D.insert_core, D.dedup_keep
        pack, unpack = PackSpec.pack, PackSpec.unpack
        parts, full = VSRKernel.parent_parts, VSRKernel.fingerprint
        incr = VSRKernel.fingerprint_incremental

        def insert_core(table, fps, mask):
            def snap():
                s = table["slots"]
                return (fps.clone(), mask.clone(),
                        s[s[:, 0] != 0][:, :4].contiguous())
            rec.keep("fpset_insert", fps.shape[0], snap)
            return ins(table, fps, mask)

        def dedup_keep(fps, mask):
            rec.keep("dedup_batch", fps.shape[0],
                     lambda: (fps.clone(), mask.clone()))
            return ded(fps, mask)

        def p_pack(self, flat, out=None, dest=None):
            rec.keep("pack", flat.shape[0], lambda: (
                self, flat.clone(), None if dest is None else dest.clone(),
                None if out is None else out.shape[0]))
            return pack(self, flat, out, dest)

        def p_unpack(self, packed, rows=None):
            rec.keep("unpack", packed.shape[0] if rows is None
                     else rows.shape[0],
                     lambda: (self, packed.clone(),
                              None if rows is None else rows.clone()))
            return unpack(self, packed, rows)

        def p_parts(self, flat):
            rec.keep("vsr_fp_parts", flat.shape[0],
                     lambda: (self, flat.clone()))
            return parts(self, flat)

        def p_full(self, flat):
            rec.keep("vsr_fp_full", flat.shape[0],
                     lambda: (self, flat.clone()))
            return full(self, flat)

        def p_incr(self, succ, ri, ts, pidx, parent, prt):
            rec.keep("vsr_fp_incremental", succ.shape[0], lambda: (
                self, succ.clone(), ri.clone(), ts.clone(), pidx.clone(),
                parent.clone(), tuple(x.clone() for x in prt)))
            return incr(self, succ, ri, ts, pidx, parent, prt)

        D.insert_core, D.dedup_keep = insert_core, dedup_keep
        PackSpec.pack, PackSpec.unpack = p_pack, p_unpack
        VSRKernel.parent_parts, VSRKernel.fingerprint = p_parts, p_full
        VSRKernel.fingerprint_incremental = p_incr

        def uninstall():
            D.insert_core, D.dedup_keep = ins, ded
            PackSpec.pack, PackSpec.unpack = pack, unpack
            VSRKernel.parent_parts, VSRKernel.fingerprint = parts, full
            VSRKernel.fingerprint_incremental = incr
        return uninstall


def kernel_row(out, name, ms, plain_ms, err, nbytes, nops,
               library_ms=None, extra=None, label=None):
    """Append one kernels-line row (``label`` names a kernel measured
    on another path than the BFS one) and fail on a disagreement."""
    from tpuvsr_torch import kernels
    (ms, issue_ms, timed_by), (plain_ms, plain_issue_ms, plain_timed_by) \
        = ms, plain_ms
    library_timed_by = None
    if library_ms is not None:
        library_ms, _issue, library_timed_by = library_ms
    b, by = bound(nbytes, nops)
    r = {"name": label or name, "route": "cuda",
         "source": "tpuvsr_torch/csrc/" + kernels.KERNELS[name][0] + ".cu",
         "replaces": kernels.KERNELS[name][1], "launches": None,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b, "bound_by": by, "library_ms": library_ms}
    r.update(extra or {}, kernel=name, issue_ms=issue_ms,
             plain_issue_ms=plain_issue_ms, bytes=nbytes, ops=nops)
    # the kernels line says which of the row's times are not the
    # profiler's device time, and how they were taken
    other = {k: t for k, t in (("ms", timed_by), ("plain_ms", plain_timed_by),
                               ("library_ms", library_timed_by))
             if t not in (None, "torch.profiler")}
    if other:
        r["timed_by"] = other
    out.append(r)
    print(f"  {r['name']}: err {err} ms {ms:.4f} plain {plain_ms:.4f} "
          f"bound {b:.5f} ({by}) library {library_ms}"
          + (f" (timed by {other})" if other else ""), flush=True)
    need(err == 0, f"{r['name']} disagrees with its plain version")


def check_insert(out, fps, mask, table_fps, cap, label=None):
    """K1 against its plain version: the recorded batch (first
    occurrences only, as the callers insert) into a table of ``cap``
    slots holding ``table_fps``; timed on fresh random batches."""
    import torch
    from tpuvsr_torch.engine import fpset as F
    dev = fps.device
    n = fps.shape[0]
    keep = F.dedup_batch(fps, mask)
    canon = torch.zeros_like(mask)
    canon[keep[0]] = keep[1]
    base = F.empty_table(cap, dev)
    ones = torch.ones((table_fps.shape[0],), dtype=torch.bool, device=dev)
    F.insert_core(base, table_fps, ones)
    ta = {"slots": base["slots"].clone()}
    _t, fk, ok_ = F.insert_core(ta, fps, canon)
    tb = {"slots": base["slots"].clone()}
    _t, fp_, op_ = F.insert_core_plain(tb, fps, canon)
    torch.cuda.synchronize()

    def members(t):
        s = t["slots"]
        return torch.unique(s[s[:, 0] != 0][:, :4], dim=0)
    need(bool(ok_) == op_, "fpset_insert overflow flag differs")
    need(torch.equal(members(ta), members(tb)),
         "fpset_insert membership differs from the plain version")
    n_fresh = int(fk.sum())
    need(n_fresh > 0, "the recorded insert batch has no fresh lane")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def fresh_batch():
        return torch.randint(-2**31, 2**31 - 1, (n, 4), dtype=torch.int32,
                             device=dev, generator=gen)
    # enough for every call cuda_ms may make, fallbacks included
    it = iter([fresh_batch() for _ in range(100)])
    ms = cuda_ms(lambda: F.insert_core(ta, next(it), canon), reps=20, warm=3)
    it2 = iter([fresh_batch() for _ in range(30)])
    plain_ms = cuda_ms(lambda: F.insert_core_plain(tb, next(it2), canon),
                       reps=3, warm=1)
    # bytes the data needs: mask, fresh, fps, one 20-byte probe read per
    # masked lane, one 20-byte row written per fresh lane
    # (fingerprint read only where the mask is set)
    n_mask = int(canon.sum())
    kernel_row(out, "fpset_insert", ms, plain_ms, max_abs(fk, fp_),
               n_mask * 16 + 2 * n + 20 * n_mask + 20 * n_fresh, 0,
               extra={"shape": [n, 4], "table_slots": cap,
                      "masked": n_mask, "fresh": n_fresh}, label=label)


def fp_rows(out, calls, names, evict=None):
    """K3's three kernels (``names``: their KERNELS names) against their
    plain versions on the recorded ``calls``, timed (after ``evict``,
    ``l2_evict()``, when given) with their bounds: the row columns each
    hashes (``nrep``, ``nmsg`` and the global row's ``nglob``), four
    multiply-adds a column a word."""
    kern, flat = calls[names["parts"]][1]
    B, L = flat.shape
    a = kern.parent_parts(flat)
    p = kern.parent_parts_plain(flat)
    err = max(max_abs(x, y) for x, y in zip(a, p))
    ms = cuda_ms(lambda: kern.parent_parts(flat), evict=evict)
    plain_ms = cuda_ms(lambda: kern.parent_parts_plain(flat), reps=5)
    cols = kern.R * kern.nrep + kern.M * kern.nmsg
    kernel_row(out, names["parts"], ms, plain_ms, err,
               B * L * 4 + B * (kern.R + kern.M + 1) * 16, B * cols * 4 * 2,
               extra={"shape": [B, L]})
    kern, flat = calls[names["full"]][1]
    B, L = flat.shape
    ms = cuda_ms(lambda: kern.fingerprint(flat), evict=evict)
    plain_ms = cuda_ms(lambda: kern.fingerprint_plain(flat), reps=5)
    kernel_row(out, names["full"], ms, plain_ms,
               max_abs(kern.fingerprint(flat), kern.fingerprint_plain(flat)),
               B * L * 4 + B * 16, B * (cols + kern.nglob) * 4 * 2,
               extra={"shape": [B, L]})
    kern, succ, ri, ts, pidx, parent, prt = calls[names["incremental"]][1]
    n, L = succ.shape
    args = (succ, ri, ts, pidx, parent, prt)
    ms = cuda_ms(lambda: kern.fingerprint_incremental(*args), evict=evict)
    plain_ms = cuda_ms(lambda: kern.fingerprint_incremental_plain(*args),
                       reps=5)
    n_ts = int((ts >= 0).sum())
    cols_read = n * (kern.nrep + kern.nglob) + n_ts * kern.nmsg
    kernel_row(out, names["incremental"], ms, plain_ms,
               max_abs(kern.fingerprint_incremental(*args),
                       kern.fingerprint_incremental_plain(*args)),
               cols_read * 4 + n * (ri.element_size() + pidx.element_size()
                                    + ts.shape[1] * 4) + (n + n_ts) * 16
               + n * 16, cols_read * 4 * 2,
               extra={"shape": [n, L], "touched_slots": n_ts})


def check_kernels(rec):
    """Phase 3: every kernel against its plain version, on the card."""
    import torch
    from tpuvsr_torch.engine import fpset as F
    out = []
    dev = torch.device("cuda")

    def row(*a, **k):
        kernel_row(out, *a, **k)

    # -- K1: the recorded batch into a 2^26-slot table holding what the
    # recording run's table held just before that insert
    fps, mask, table_fps = rec.calls["fpset_insert"][1]
    check_insert(out, fps, mask, table_fps, 1 << 26)

    # -- K2: dedup
    fps, mask = rec.calls["dedup_batch"][1]
    n = fps.shape[0]
    kk = F.dedup_keep(fps, mask)
    perm, keep = F.dedup_batch(fps, mask)
    kp = torch.zeros_like(mask)
    kp[perm] = keep
    ms = cuda_ms(lambda: F.dedup_keep(fps, mask))
    plain_ms = cuda_ms(lambda: F.dedup_batch(fps, mask), reps=5)
    need(torch.equal(lexsort_keep(fps, mask), kk),
         "dedup_batch disagrees with the torch.sort lexsort")
    lib = cuda_ms(lambda: lexsort_keep(fps, mask))
    row("dedup_batch", ms, plain_ms, max_abs(kk, kp), n * 16 + 2 * n, 0,
        library_ms=lib, extra={"shape": [n, 4],
                               "library": "torch.sort lexsort, 2 keys"})

    # -- K3
    from tpuvsr_torch.models.vsr_kernel import VSRKernel
    fp_rows(out, rec.calls, VSRKernel.FP_KERNELS)

    # -- K4
    pk, flat, dest, out_rows = rec.calls["pack"][1]
    B, L = flat.shape
    lanes_read = int((pk._bits > 0).sum())     # a 0-bit lane is not read
    if dest is None:
        wk, wp = pk.pack(flat), pk.pack_plain(flat)
        n_rows = B
        call = lambda: pk.pack(flat)
        pcall = lambda: pk.pack_plain(flat)
    else:
        oa = torch.zeros((out_rows, pk.words), dtype=torch.int32, device=dev)
        ob = oa.clone()
        wk, wp = pk.pack(flat, oa, dest), pk.pack_plain(flat, ob, dest)
        n_rows = int((dest >= 0).sum())
        call = lambda: pk.pack(flat, oa, dest)
        pcall = lambda: pk.pack_plain(flat, ob, dest)
    # a row whose dest is -1 is neither read nor written
    row("pack", cuda_ms(call), cuda_ms(pcall, reps=5), max_abs(wk, wp),
        n_rows * lanes_read * 4 + (0 if dest is None else B * 4)
        + n_rows * pk.words * 4, 0,
        extra={"shape": [B, L], "rows_written": n_rows,
               "lanes_read": lanes_read})
    pk, packed, rows = rec.calls["unpack"][1]
    B = packed.shape[0] if rows is None else rows.shape[0]
    row("unpack", cuda_ms(lambda: pk.unpack(packed, rows)),
        cuda_ms(lambda: pk.unpack_plain(packed, rows), reps=5),
        max_abs(pk.unpack(packed, rows), pk.unpack_plain(packed, rows)),
        B * pk.words * 4 + B * 8 + B * pk.lanes * 4, 0,
        extra={"shape": [B, pk.lanes]})
    torch.cuda.synchronize()
    return out


class HuntRecorder:
    """Keeps, during a hunt run, the inputs of the K5 call with the most
    enabled lanes, the swarm-noise call, the splitter's K1/K2/K3 calls on
    walker batches with the most live walkers, and a K10 step."""

    def __init__(self, walkers):
        self.walkers = walkers
        self.calls = {}

    keep = Recorder.keep

    def install(self):
        import torch
        from tpuvsr_torch.engine import fpset as F
        from tpuvsr_torch.models.vsr_kernel import VSRKernel
        from tpuvsr_torch.sim import rng
        rec, W = self, self.walkers
        choose, swarm = rng.choose_lanes, rng.swarm_noise
        ins, ded, full = F.insert_core, F.dedup_keep, VSRKernel.fingerprint

        def p_choose(wkeys, d, en, lane_aid, wlogw=None):
            rec.keep("fleet_choose", int(en.sum()), lambda: (
                wkeys.clone(), d if isinstance(d, int) else d.clone(),
                en.clone(), lane_aid.clone(),
                None if wlogw is None else wlogw.clone()))
            return choose(wkeys, d, en, lane_aid, wlogw)

        def p_swarm(wkeys, logw, sigma):
            rec.keep("fleet_swarm_noise", wkeys.shape[0], lambda: (
                wkeys.clone(), logw.clone(), sigma))
            return swarm(wkeys, logw, sigma)

        def p_insert(table, fps, mask):
            if fps.shape[0] == W:      # not a grow() chunk
                def snap():
                    s = table["slots"]
                    return (fps.clone(), mask.clone(),
                            s[s[:, 0] != 0][:, :4].contiguous(),
                            s.shape[0])
                rec.keep("fpset_insert", int(mask.sum()), snap)
            return ins(table, fps, mask)

        def p_dedup(fps, mask):
            rec.keep("dedup_batch", int(mask.sum()),
                     lambda: (fps.clone(), mask.clone()))
            return ded(fps, mask)

        def p_full(self, flat):
            rec.keep("vsr_fp_full", flat.shape[0],
                     lambda: (self, flat.clone()))
            return full(self, flat)

        succ = VSRKernel.successors

        def p_succ(self, flat, pidx, aid, lane, inv_mask, out=None,
                   halt=None):
            r = succ(self, flat, pidx, aid, lane, inv_mask, out, halt)
            # every step has W items: keep one that runs the most
            # actions (the first steps run two), then the most enabled
            n_act = int(torch.unique(aid[r["en2"]]).numel())
            rec.keep("vsr_actions", n_act * W + int(r["en2"].sum()), lambda: (
                self, flat.clone(), pidx.clone(), aid.clone(), lane.clone(),
                inv_mask, None))
            return r

        rng.choose_lanes, rng.swarm_noise = p_choose, p_swarm
        F.insert_core, F.dedup_keep = p_insert, p_dedup
        VSRKernel.fingerprint, VSRKernel.successors = p_full, p_succ

        def uninstall():
            rng.choose_lanes, rng.swarm_noise = choose, swarm
            F.insert_core, F.dedup_keep = ins, ded
            VSRKernel.fingerprint, VSRKernel.successors = full, succ
        return uninstall


def threefry_ops(blocks):
    """Integer operations of ``blocks`` threefry2x32 hashes: 20 rounds
    of add, rotate (two shifts and an or) and xor, 5 key injections of
    3 adds, the 2 initial adds and the output xor."""
    return blocks * (20 * 5 + 5 * 3 + 2 + 1)


def check_hunt_kernels(rec):
    """Phase 6a: K5 bit for bit against sim/rng.py on the recorded
    hunt inputs, and K1/K2/K3 on the hunt's own batches; all timed."""
    import torch
    from tpuvsr_torch.engine import fpset as F
    from tpuvsr_torch.sim import rng
    out = []

    # -- K5: lane choice
    wkeys, d, en, lane_aid, wlogw = rec.calls["fleet_choose"][1]
    W, L = en.shape
    n_act = 0 if wlogw is None else wlogw.shape[1]
    lk, ck = rng.choose_lanes(wkeys, d, en, lane_aid, wlogw)
    lp, cp = rng.choose_lanes_plain(wkeys, d, en, lane_aid, wlogw)
    err = max(max_abs(lk, lp), max_abs(ck, cp))
    ms = cuda_ms(lambda: rng.choose_lanes(wkeys, d, en, lane_aid, wlogw))
    plain_ms = cuda_ms(lambda: rng.choose_lanes_plain(
        wkeys, d, en, lane_aid, wlogw), reps=5)
    # what these inputs need: the enabled rows, log-weights, lane table,
    # keys in, lanes and flags out; 3 key derivations a walker, one
    # gumbel draw (two logs, ~60 float ops) per enabled action, one
    # uniform a lane of the chosen action, 2 ops a lane to test it
    aid = lane_aid.long()
    if n_act:
        act_en = torch.zeros((W, n_act), dtype=torch.int32,
                             device=en.device).index_add_(
            1, aid, en.to(torch.int32)) > 0
        chosen = int((en & (aid[None, :] == aid[lk.long()][:, None]))
                     .sum())
        n_g = int(act_en.sum())
        blocks = 3 * W + n_g + chosen
        nops = threefry_ops(blocks) + 60 * n_g + 2 * W * L
    else:
        blocks = W + int(en.sum())
        nops = threefry_ops(blocks) + 2 * W * L
    nbytes = (W * L + W * n_act * 4 + L * 4 + W * 8 + W * 4 + W)
    kernel_row(out, "fleet_choose", ms, plain_ms, err, nbytes, nops,
               extra={"shape": [W, L], "n_act": n_act,
                      "enabled": int(en.sum()), "blocks": blocks})

    # -- K5: swarm noise (compared as float bits)
    wk, logw, sigma = rec.calls["fleet_swarm_noise"][1]
    W, n_act = wk.shape[0], logw.shape[0]
    a = rng.swarm_noise(wk, logw, sigma)
    b = rng.swarm_noise_plain(wk, logw, sigma)
    err = max_abs(a.view(torch.int32), b.view(torch.int32))
    ms = cuda_ms(lambda: rng.swarm_noise(wk, logw, sigma))
    plain_ms = cuda_ms(lambda: rng.swarm_noise_plain(wk, logw, sigma),
                       reps=5)
    # a key derivation a walker, a uniform an entry, erf_inv (~40 float
    # ops: log1p, its polynomial, 9 multiply-adds) and the scaling
    kernel_row(out, "fleet_swarm_noise", ms, plain_ms, err,
               W * 8 + n_act * 4 + W * n_act * 4,
               threefry_ops(W + W * n_act) + 45 * W * n_act,
               extra={"shape": [W, n_act], "sigma": sigma})

    # -- K1 / K2 / K3 on the hunt's batches
    fps, mask, table_fps, cap = rec.calls["fpset_insert"][1]
    check_insert(out, fps, mask, table_fps, cap,
                 label="fpset_insert (hunt)")
    fps, mask = rec.calls["dedup_batch"][1]
    n = fps.shape[0]
    perm, keep = F.dedup_batch(fps, mask)
    kp = torch.zeros_like(mask)
    kp[perm] = keep
    kernel_row(out, "dedup_batch",
               cuda_ms(lambda: F.dedup_keep(fps, mask)),
               cuda_ms(lambda: F.dedup_batch(fps, mask), reps=5),
               max_abs(F.dedup_keep(fps, mask), kp), n * 16 + 2 * n, 0,
               library_ms=cuda_ms(lambda: lexsort_keep(fps, mask)),
               extra={"shape": [n, 4]}, label="dedup_batch (hunt)")
    kern, flat = rec.calls["vsr_fp_full"][1]
    B, L = flat.shape
    cols = kern.R * kern.nrep + kern.M * kern.nmsg
    kernel_row(out, "vsr_fp_full", cuda_ms(lambda: kern.fingerprint(flat)),
               cuda_ms(lambda: kern.fingerprint_plain(flat), reps=5),
               max_abs(kern.fingerprint(flat), kern.fingerprint_plain(flat)),
               B * L * 4 + B * 16, B * cols * 4 * 2,
               extra={"shape": [B, L]}, label="vsr_fp_full (hunt)")
    check_actions(out, rec.calls["vsr_actions"][1],
                  label="vsr_actions (hunt step)")
    check_wide_actions(rec.calls["vsr_actions"][1])
    torch.cuda.synchronize()
    return out


def check_wide_actions(call, max_msgs=448):
    """K10 on a message table grown until a row no longer fits the 48 KB
    of shared memory a block has by default (the kernel then opts in to
    more): bit for bit against its plain version on the hunt step's
    queue, its rows padded with empty slots to ``max_msgs``."""
    import torch
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.models.registry import make_model
    kern, flat, pidx, aid, lane, mask, ok = call
    codec, wide = make_model(load_binding(DEFECT, "VSR"), max_msgs=max_msgs)
    need(wide.pk.lanes * 4 > 48 * 1024, f"MAX_MSGS {max_msgs} gives "
         f"{wide.pk.lanes} lanes, which fit in 48 KB")
    rows = wide.pk.flatten(codec.pad_msgs(kern.pk.unflatten(flat),
                                          kern.M)).contiguous()
    if ok is None:
        ok = torch.ones((pidx.shape[0],), dtype=torch.bool,
                        device=flat.device)
    a = wide.successors(rows, pidx, aid, lane, mask)
    p = wide.successors_plain(rows, pidx, aid, lane, mask)
    err = max(max_abs(a[k][ok], p[k][ok]) for k in a)
    need(err == 0, f"K10 at MAX_MSGS {max_msgs} differs from its plain "
         f"version by {err}")
    print(f"  vsr_actions at MAX_MSGS {max_msgs} ({wide.pk.lanes} lanes, "
          f"over 48 KB a row): equal to its plain version", flush=True)


def check_replay(sim, trace):
    """Every step of a reported trace is an enabled successor of the
    state before it under the recorded action (K10 over every lane of
    the state before; states compared by fingerprint, which does not see
    the order of message slots); the first state passes the invariant
    and the last one fails AcknowledgedWriteNotLost."""
    import numpy as np
    import torch
    kern, codec, pk = sim.kern, sim.codec, sim.kern.pk
    lane_action = torch.as_tensor(kern.lane_action, device=sim.device)
    lane_param = torch.as_tensor(kern.lane_param, device=sim.device)
    zeros = torch.zeros_like(lane_action)
    mask = kern.invariant_mask(["AcknowledgedWriteNotLost"])

    def dense(e):
        return {k: torch.as_tensor(np.asarray(v))[None].to(sim.device)
                for k, v in codec.encode(e.state).items()}
    def holds(flat):
        # the invariant of the trace's own rows (a check off the path)
        return bool(kern.invariant_fns(["AcknowledgedWriteNotLost"])[0][1](
            pk.unflatten(flat))[0])
    cur = pk.flatten(dense(trace[0])).contiguous()
    need(holds(cur),
         "the hunt trace's first state already violates the invariant")
    last_ok = None
    for i, e in enumerate(trace[1:], 1):
        nxt = pk.flatten(dense(e)).contiguous()
        o = kern.successors(cur, zeros, lane_action, lane_param, mask)
        fps = kern.fingerprint(o["succ"])
        want = kern.fingerprint(nxt)
        aid = list(kern.action_names).index(e.action_name)
        hit = o["en2"] & (lane_action == aid) & (fps == want).all(dim=1)
        need(bool(hit.any()), f"hunt trace step {i} ({e.action_name}) is "
             f"not an enabled successor")
        last_ok = bool(o["iok"][hit][0])
        cur = nxt
    need(last_ok is False and not holds(cur),
         "the hunt trace's last state does not violate "
         "AcknowledgedWriteNotLost")


def round_digest(violated, dead, hists, steps, chunks, fresh, novelty):
    """The comparable record of one guided round (the digest
    tests/test_torch_fleet.py:round_digest computes for the JAX round)."""
    import hashlib
    import numpy as np

    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
        return h.hexdigest()[:16]
    return {"steps": int(steps), "chunks": int(chunks),
            "events": sha(np.asarray(violated, np.int32),
                          np.asarray(dead, np.int32)),
            "hists": sha(*[np.asarray(h, np.int32) for pair in hists
                           for h in pair]),
            "fresh": int(fresh),
            "novelty": sha(np.asarray(novelty, np.float64))}


def shipped_round(doc):
    """Phase 6d: one guided round on the shipped model against the JAX
    CPU record (the splitter's seen-set holds canonical fingerprints)."""
    import torch
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.sim import NoveltySplitter, rng
    from tpuvsr_torch.sim.defect_hunt import WEIGHTS
    from tpuvsr_torch.sim.fleet import FleetSimulator
    print("phase 6d: guided round on the shipped model (symmetry on)",
          flush=True)
    split = NoveltySplitter(frac=0.25, decay=0.5, hunt_beta=1.5)
    sim = FleetSimulator(load_binding(SHIPPED, "VSR"), walkers=64,
                         chunk_steps=8, max_msgs=48, action_weights=WEIGHTS,
                         swarm_sigma=1.0, split=split, device="cuda")
    need(sim._canon is not None, "the shipped round has no CanonSpec")
    v, d, h, _i, steps, _done, chunks = sim.run_round(
        base=0, active=64, depth=16, key=rng.prng_key(2, device="cuda"))
    torch.cuda.synchronize()
    got = round_digest(v, d, [(a.cpu().numpy(), p.cpu().numpy())
                              for a, p in h], steps, chunks,
                       split.fresh_total, split.novelty)
    doc["shipped_round"] = got
    need(got == SHIPPED_ROUND, f"shipped round {got}, the JAX CPU record "
         f"has {SHIPPED_ROUND}")
    print(f"  shipped round equals the JAX record: {got}", flush=True)


def hunt_phase(args, doc):
    """Phase 6: the hunt path.  Returns its kernels-line rows, with the
    launch counts of the timed hunt (6c)."""
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.sim import rng
    from tpuvsr_torch.sim.defect_hunt import hunt, make_fleet
    from tpuvsr_torch.testing import stub_fleet
    H = HUNT
    seeds = list(HUNT_RECORD)
    run = lambda seed: hunt(H["walkers"], H["depth"], H["max_seconds"],
                            seed, H["sigma"], H["mode"], device="cuda")

    def same_as_record(seed, res, what):
        want = HUNT_RECORD[seed]
        got = {"ok": res.ok, "violated": res.violated_invariant,
               "walks": res.walks, "steps": res.steps,
               "trace_len": len(res.trace),
               "actions": [e.action_name for e in res.trace[1:]]}
        for k, v in got.items():
            need(v == want[k], f"{what} seed {seed}: {k} {v!r}, the JAX "
                 f"CPU record has {want[k]!r}")

    print("phase 6a: hunt recording pass (its first round), K5 and the "
          "hunt's K1/K2/K3", flush=True)
    key = rng.prng_key(seeds[0], device="cuda")

    def first_round(graphs):
        sim = make_fleet(H["walkers"], H["sigma"], H["mode"],
                         device="cuda")
        sim.graphs = graphs
        out = sim.run_round(base=0, active=H["walkers"], depth=H["depth"],
                            key=key)
        torch.cuda.synchronize()
        return out

    rec = HuntRecorder(H["walkers"])
    uninstall = rec.install()
    t0 = time.time()
    # eager, so the recorder sees every call
    violated, dead, hists, init, steps, done, _c = first_round(False)
    uninstall()
    doc["hunt_record_s"] = time.time() - t0
    need(done and steps > 0, f"recording round: {steps} steps")
    doc["hunt_recorded"] = {k: v[0] for k, v in rec.calls.items()}
    rows = check_hunt_kernels(rec)
    del rec
    # the timed hunt replays a CUDA graph of each step: the same round
    # through it must give the eager round's walks bit for bit
    g_viol, g_dead, g_hists, g_init, g_steps, _d, _c = first_round(True)
    need(g_steps == steps and np.array_equal(g_viol, violated)
         and np.array_equal(g_dead, dead) and len(g_hists) == len(hists)
         and all(torch.equal(a, b) for x, y in zip(hists, g_hists)
                 for a, b in zip(x, y))
         and all(np.array_equal(init[k], g_init[k]) for k in init),
         "the graph path's first hunt round differs from the eager one")
    print(f"  graph path equals the eager path on the first round "
          f"({steps} steps)", flush=True)

    print("phase 6b: counter-stub fleet", flush=True)
    r = stub_fleet(walkers=64, inv_x_bound=2, device="cuda").run(
        num=1024, depth=8, seed=7)
    got = {"violated": r.violated_invariant, "walks": r.walks,
           "steps": r.steps, "trace": [[e.action_name, e.state["x"],
                                        e.state["y"]] for e in r.trace]}
    need(got == STUB_FLEET, f"stub fleet: {got}")
    print(f"  stub fleet: {r.violated_invariant} trace of "
          f"{len(r.trace)} states, walks {r.walks}, steps {r.steps}",
          flush=True)

    print(f"phase 6c: guided defect hunt, {H['walkers']} walkers, depth "
          f"{H['depth']}", flush=True)
    doc["hunt"] = {}
    counts = None
    for seed in seeds:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        plain0 = plain_calls()
        t0 = time.time()
        result, res, sim = run(seed)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if counts is None:
            counts = kernels.launch_counts()
            k10_only(counts, plain0, "the hunt path")
            need(counts["vsr_guards"] > 0, "K6 was not launched on the "
                 "hunt path")
            need("grow_dispatch_group" not in res.metrics["counters"],
                 "the hunt grew dispatch caps on the card")
        same_as_record(seed, res, "hunt")
        h = {"seed": seed, "wall_s": wall, "walks": res.walks,
             "steps": res.steps, "ok": res.ok,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "metrics": res.metrics, "launches": kernels.launch_counts()}
        if result is not None:
            need(sim.event["walk"] == HUNT_RECORD[seed]["walk"],
                 f"hunt seed {seed}: violating walk {sim.event['walk']}, "
                 f"the JAX CPU record has {HUNT_RECORD[seed]['walk']}")
            check_replay(sim, res.trace)
            h.update(result=result, event=sim.event)
            print(f"  seed {seed}: {result['violated']}, trace replayed "
                  f"on the card", flush=True)
            print(f"time_to_violation_s {result['time_to_violation_s']}")
            print(f"walks {res.walks}")
            print(f"steps {res.steps}")
            print(f"trace_len {len(res.trace)}")
            print(f"final_action {res.trace[-1].action_name}")
            print(f"violating_walk {sim.event['walk']}", flush=True)
            print(f"  wall {wall:.3f}s, max_memory_allocated "
                  f"{h['max_memory_allocated']}, {res.metrics['counters']}",
                  flush=True)
        else:
            print(f"  seed {seed}: no violation in {res.walks} walks "
                  f"({wall:.1f}s), as in the JAX record", flush=True)
        doc["hunt"][str(seed)] = h
    for k in rows:
        k["launches"] = counts[k["kernel"]]
        need(k["launches"] > 0, f"{k['name']} was not launched on the "
             f"hunt path")
    need(counts["vsr_canon"] == 0, "K9 was launched on the hunt path")
    shipped_round(doc)

    if args.profile:
        # one steady round (the second of the hunt, graphs captured in
        # the first): the profiler's CPU tracing would swamp a full hunt
        from torch.profiler import ProfilerActivity, profile
        sim = make_fleet(H["walkers"], H["sigma"], H["mode"], device="cuda")
        sim.run(num=H["walkers"], depth=H["depth"], seed=seeds[0])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sim.run_round(base=H["walkers"], active=H["walkers"],
                          depth=H["depth"],
                          key=rng.prng_key(seeds[0], device="cuda"))
            torch.cuda.synchronize()
            wall = time.time() - t0
        dev_us = device_us(prof)
        doc["profile_hunt_round"] = {
            "wall_s": wall, "device_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / wall,
            "table": prof.key_averages().table(sort_by="cuda_time_total",
                                               row_limit=40)}
        print(f"  profiled hunt round: wall {wall:.3f}s, device busy "
              f"{dev_us / 1e6:.3f}s", flush=True)
    return rows


class FusedRecorder:
    """Keeps, during an eager run_fused, the inputs of the K6, K7 and K8
    calls that did the most work (cloned before the call: K7 and K8
    update their buffers and the carry in place).  Calls on a halted
    carry are skipped: they commit nothing.  K8's level step keeps the
    largest level's rows only, and commit_finish its small inputs (the
    check scatters into fresh pointer columns)."""

    def __init__(self):
        self.calls = {}

    def keep(self, name, size, snap):
        if snap is not None and size > self.calls.get(name, (-1, None))[0]:
            self.calls[name] = (size, snap)

    def install(self):
        import torch
        from tpuvsr_torch.engine import device_bfs as D
        from tpuvsr_torch.engine import tile as TL
        from tpuvsr_torch.models.vsr_kernel import VSRKernel
        rec = self
        guards = VSRKernel.guard_matrix
        comp, pre, fin, lvl = (D.compact, D.commit_prefix, D.commit_finish,
                               D.level_step)
        halted = lambda c: bool(c[TL.C_HALT] != 0)

        def p_guards(self, flat, out=None, halt=None):
            snap = None if halt is not None and bool(halt[0]) else \
                (self, flat.clone())
            r = guards(self, flat, out, halt)
            rec.keep("vsr_guards", int(r[0].sum()), snap)
            return r

        def p_compact(en, valid, segs, q, carry=None):
            snap = None if carry is not None and halted(carry) else (
                en.clone(), valid.clone(), segs, q["pidx"].shape[0],
                None if carry is None else carry.clone())
            r = comp(en, valid, segs, q, carry)
            rec.keep("compact", int(q["cnts"].sum()), snap)
            return r

        def p_prefix(carry, q, en2, iok, err, tile, mcommit, keep=None):
            if not halted(carry) and keep is None:
                rec.keep("commit_prefix", int(en2.sum()), (
                    carry.clone(), {k: v.clone() for k, v in q.items()},
                    en2.clone(), iok.clone(), err.clone(), tile.shape[0]))
            return pre(carry, q, en2, iok, err, tile, mcommit, keep)

        def p_finish(carry, q, tile, fresh, ovf_i, en_any, valid, bufs,
                     dest, kept=None, amp=None):
            if not halted(carry) and kept is None:
                rec.keep("commit_finish", int(fresh.sum()), (
                    carry.clone(), {k: v.clone() for k, v in q.items()},
                    tile.clone(), fresh.clone(), ovf_i.clone(),
                    en_any.clone(), valid.clone(), bufs.cap))
            return fin(carry, q, tile, fresh, ovf_i, en_any, valid, bufs,
                       dest, kept, amp)

        def p_level(carry, bufs, front, tp, lvl_buf, T):
            c = carry.tolist()
            n = c[TL.C_NN]
            if not c[TL.C_HALT] and c[TL.C_T] >= -(-c[TL.C_N_FRONT] // T):
                rec.keep("level_step", n, (
                    carry.clone(), bufs.nb[:n + 1].clone(),
                    bufs.par[:n + 1].clone(), bufs.act[:n + 1].clone(),
                    bufs.prm[:n + 1].clone(), tp[0].shape[0],
                    lvl_buf.shape[0], T))
            return lvl(carry, bufs, front, tp, lvl_buf, T)

        VSRKernel.guard_matrix = p_guards
        D.compact, D.commit_prefix, D.commit_finish, D.level_step = (
            p_compact, p_prefix, p_finish, p_level)

        def uninstall():
            VSRKernel.guard_matrix = guards
            D.compact, D.commit_prefix, D.commit_finish, D.level_step = (
                comp, pre, fin, lvl)
        return uninstall


def l2_evict(dev):
    """Two equal int32 tensors of 256 MB each, five times the H100's
    50 MB L2: a copy of one into the other leaves none of a timed
    call's inputs in L2."""
    import torch
    return [torch.zeros((1 << 26,), dtype=torch.int32, device=dev)
            for _ in range(2)]


def restored_ms(fn, carry, saved, reps=20, warm=3, evict=None):
    """cuda_ms of ``fn()`` on a carry restored from ``saved`` before
    every call (the kernel steps the carry), after a copy of ``evict``
    (``l2_evict()``) where the call would otherwise find its rows in
    L2; those device-to-device copies are left out of the device time
    (the issue time keeps them)."""
    return cuda_ms(fn, reps=reps, warm=warm, evict=evict,
                   pre=lambda: carry.copy_(saved))


def check_fused_kernels(rec):
    """Phase 7b: K6, K7 and K8 against their plain versions on the
    recorded inputs, bit for bit; each timed with its bound."""
    import torch
    from tpuvsr_torch.engine import tile as TL
    from tpuvsr_torch.engine.device_bfs import _Bufs
    from tpuvsr_torch.models.vsr_kernel import GUARD_PLANES
    out = []

    # -- K6: the guard matrix of the tile with the most enabled lanes
    kern, flat = rec.calls["vsr_guards"][1]
    dev = flat.device
    B = flat.shape[0]
    a, p = kern.guard_matrix(flat), kern.guard_matrix_plain(flat)
    err = max(max_abs(a[0], p[0]), max_abs(a[1], p[1]))
    span = {k: e - s for k, _sh, s, e in kern.pk._splits}
    lanes_read = sum(span[k] for k in GUARD_PLANES)
    sgs = kern.lane_action == kern.action_names.index("SendGetState")
    n_scan = int(a[0][:, torch.as_tensor(sgs, device=dev)].sum())
    kernel_row(out, "vsr_guards", cuda_ms(lambda: kern.guard_matrix(flat)),
               cuda_ms(lambda: kern.guard_matrix_plain(flat), reps=5), err,
               B * lanes_read * 4 + B * kern.n_lanes + B,
               10 * B * kern.n_lanes + 20 * kern.M * n_scan,
               extra={"shape": [B, kern.pk.lanes], "n_lanes": kern.n_lanes,
                      "enabled": int(a[0].sum())})

    # -- K7: the work queue of the tile with the most enabled items
    en, valid, segs, total, carry = rec.calls["compact"][1]
    n_act = len(segs.host)
    qa, qb = (TL.queue_buffers(total, n_act, dev) for _ in range(2))
    ca, cb = carry.clone(), carry.clone()
    TL.compact(en, valid, segs, qa, ca)
    TL.compact_plain(en, valid, segs, qb, cb)
    err = max([max_abs(qa[k], qb[k]) for k in qa] + [max_abs(ca, cb)])
    T, n_lanes = en.shape
    m = en & valid[:, None]
    kernel_row(out, "compact",
               cuda_ms(lambda: TL.compact(en, valid, segs, qa, ca)),
               cuda_ms(lambda: TL.compact_plain(en, valid, segs, qb, cb),
                       reps=5), err,
               T * n_lanes + T + 16 * n_act + 13 * total + 9 * n_act,
               2 * T * n_lanes,
               library_ms=cuda_ms(lambda: torch.nonzero(m)),
               extra={"shape": [T, n_lanes], "queue": total,
                      "enabled": int(qa["cnts"].sum()),
                      "library": "torch.nonzero of the masked matrix"})

    # -- K8: commit_prefix
    carry, q, en2, iok, errv, tlen = rec.calls["commit_prefix"][1]
    total = en2.shape[0]
    ta, tb = (torch.zeros((tlen,), dtype=torch.int64, device=dev)
              for _ in range(2))
    ma, mb = (torch.zeros((total,), dtype=torch.bool, device=dev)
              for _ in range(2))
    TL.commit_prefix(carry, q, en2, iok, errv, ta, ma)
    TL.commit_prefix_plain(carry, q, en2, iok, errv, tb, mb)
    n_ok = int((en2 & q["ok"]).sum())
    kernel_row(out, "commit_prefix",
               cuda_ms(lambda: TL.commit_prefix(carry, q, en2, iok, errv,
                                                ta, ma)),
               cuda_ms(lambda: TL.commit_prefix_plain(
                   carry, q, en2, iok, errv, tb, mb), reps=5),
               max(max_abs(ta, tb), max_abs(ma, mb)),
               6 * total + 5 * n_ok + q["ovf"].numel() + 32 + total
               + 8 * tlen, 6 * total,
               extra={"shape": [total], "enabled": n_ok,
                      "mcommit": int(ma.sum())})

    # -- K8: commit_finish, into fresh pointer columns
    (carry, q, tile, fresh, ovf_i, en_any, valid,
     cap) = rec.calls["commit_finish"][1]
    total = fresh.shape[0]
    ca, cb = carry.clone(), carry.clone()
    ba, bb = _Bufs(cap, 1, dev), _Bufs(cap, 1, dev)
    da, db = (torch.zeros((total,), dtype=torch.int32, device=dev)
              for _ in range(2))
    TL.commit_finish(ca, q, tile, fresh, ovf_i, en_any, valid, ba, da)
    TL.commit_finish_plain(cb, q, tile, fresh, ovf_i, en_any, valid, bb, db)
    err = max(max_abs(ca, cb), max_abs(da, db),
              *(max_abs(getattr(ba, k), getattr(bb, k))
                for k in ("par", "act", "prm")))
    n_fresh = int(fresh.sum())
    T = valid.shape[0]
    kernel_row(out, "commit_finish",
               restored_ms(lambda: TL.commit_finish(
                   ca, q, tile, fresh, ovf_i, en_any, valid, ba, da),
                   ca, carry),
               restored_ms(lambda: TL.commit_finish_plain(
                   cb, q, tile, fresh, ovf_i, en_any, valid, bb, db),
                   cb, carry, reps=5),
               err, total + 12 * n_fresh + 2 * T + 8 * n_act
               + 8 * (carry.numel() + tile.numel())
               + 4 * total + 12 * n_fresh, 2 * total,
               extra={"shape": [total], "fresh": n_fresh})

    # -- K8: level_step at the largest level's end
    carry, nb, par, act, prm, tp_len, lvl_len, T = rec.calls["level_step"][1]
    n, words = nb.shape[0] - 1, nb.shape[1]
    outs = []
    for step in (TL.level_step, TL.level_step_plain):
        bufs = _Bufs.__new__(_Bufs)
        bufs.cap, bufs.nb, bufs.par, bufs.act, bufs.prm = n, nb, par, act, prm
        c = carry.clone()
        front = torch.zeros((n + 1, words), dtype=torch.int32, device=dev)
        tp = tuple(torch.full((tp_len,), -1, dtype=torch.int32, device=dev)
                   for _ in range(3))
        lv = torch.zeros((lvl_len,), dtype=torch.int64, device=dev)
        step(c, bufs, front, tp, lv, T)
        outs.append((c, front, tp, lv, bufs))
    (ca, fa, tpa, la, bufs_a), (cb, fb, tpb, lb, bufs_b) = outs
    err = max(max_abs(ca, cb), max_abs(fa, fb), max_abs(la, lb),
              *(max_abs(x, y) for x, y in zip(tpa, tpb)))
    evict = l2_evict(dev)
    kernel_row(out, "level_step",
               restored_ms(lambda: TL.level_step(ca, bufs_a, fa, tpa, la, T),
                           ca, carry, evict=evict),
               restored_ms(lambda: TL.level_step_plain(
                   cb, bufs_b, fb, tpb, lb, T), cb, carry, reps=5,
                   evict=evict),
               err, 2 * n * (words * 4 + 12) + 16 * carry.numel(), 0,
               extra={"shape": [n, words], "rows": n})
    torch.cuda.synchronize()
    return out


def fused_phase(args, doc, binding, run_pointers):
    """Phase 7: the fused path.  Returns its kernels-line rows, with the
    launch counts of the timed run_fused (7c)."""
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    levels = LEVELS[:args.depth + 1]

    def engine():
        return DeviceBFS(binding, tile_size=128, fpset_capacity=1 << 26,
                         device="cuda")

    print(f"phase 7a: fused recording pass (eager), depth {args.depth}",
          flush=True)
    rec = FusedRecorder()
    uninstall = rec.install()
    un_actions = record_actions(rec)
    eng = engine()
    eng.graphs = False
    t0 = time.time()
    res = eng.run_fused(max_depth=args.depth)
    uninstall()
    un_actions()
    doc["fused_record_s"] = time.time() - t0
    need(res.levels == levels, f"fused recording levels {res.levels}")
    doc["fused_recorded"] = {k: v[0] for k, v in rec.calls.items()}
    del eng
    print("phase 7b: K6, K7, K8, K10 against their plain versions",
          flush=True)
    rows = check_fused_kernels(rec)
    check_actions(rows, rec.calls["vsr_actions"][1])
    del rec

    print(f"phase 7c: run_fused, defect config to depth {args.depth}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    plain0 = plain_calls()
    eng = engine()
    t0 = time.time()
    res = eng.run_fused(max_depth=args.depth)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    k10_only(counts, plain0, "the fused path")
    need(res.ok, f"fused path: {res.violated_invariant} {res.error}")
    need(res.levels == levels, f"fused path levels {res.levels}")
    need(res.distinct_states == sum(levels),
         f"fused path distinct {res.distinct_states}")
    ptrs = [np.concatenate(getattr(eng, k))
            for k in ("_h_parent", "_h_action", "_h_param")]
    same_pointers(ptrs, run_pointers, res.levels, "fused path", args)
    c = res.metrics["counters"]
    fused = {"depth": args.depth, "levels": res.levels,
             "distinct": res.distinct_states,
             "generated": res.states_generated, "wall_s": wall,
             "distinct_per_s": res.distinct_states / wall,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "launches": counts, "metrics": res.metrics}
    doc["fused"] = fused
    print(f"  levels {res.levels}, pointer tables equal to run()'s",
          flush=True)
    print(f"  distinct {res.distinct_states} generated "
          f"{res.states_generated} wall {wall:.3f}s distinct/s "
          f"{fused['distinct_per_s']:.1f} max_memory_allocated "
          f"{fused['max_memory_allocated']}", flush=True)
    need(c["host_reads"] == c["quanta"] + c.get("level_fits", 0),
         f"fused path host reads {c}")
    print(f"  host_reads {c.get('host_reads')} (quanta {c.get('quanta')}, "
          f"level fits {c.get('level_fits', 0)}) graph_replays "
          f"{c.get('graph_replays')} replays_after_stop "
          f"{c.get('replays_after_stop')} graph_captures "
          f"{c.get('graph_captures')} growth_pauses "
          f"{c.get('growth_pauses', 0)} tiles {c.get('tiles')}", flush=True)
    print(f"  launches {counts}", flush=True)
    for k in rows:
        k["launches"] = counts[k["kernel"]]
        need(k["launches"] > 0, f"{k['name']} was not launched on the "
             f"fused path")
    need(counts["vsr_canon"] == 0, "K9 was launched on the fused path")
    del eng

    if args.profile:
        profile_quantum(doc, "profile_fused_quantum", engine(),
                        min(args.depth, 9))
    return rows


def profile_quantum(doc, key, eng, depth):
    """torch.profiler over the first quantum of ``eng.run_fused`` at its
    full size (REPLAYS_CAP tile replays between two host reads), into
    ``doc[key]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpuvsr_torch.engine.device_bfs import REPLAYS_CAP
    replay, seen = eng._replay, []

    def profiled(run_tile, n):
        if seen or n < REPLAYS_CAP:
            return replay(run_tile, n)
        seen.append(n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            h = replay(run_tile, n)
            wall_q = time.time() - t1
        dev_us = device_us(prof)
        doc[key] = {
            "replays": n, "wall_s": wall_q, "device_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / wall_q,
            "table": prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=40)}
        print(f"  profiled fused quantum ({n} tiles): wall {wall_q:.3f}s, "
              f"device busy {dev_us / 1e6:.3f}s "
              f"({dev_us / 1e6 / wall_q:.1%})", flush=True)
        return h
    eng._replay = profiled
    eng.run_fused(max_depth=depth)
    del eng._replay      # the closure refers to eng: free it without gc


class CanonRecorder:
    """Keeps, during a symmetric run, the inputs of the largest K9 call
    (under the CanonSpec's kernel name) and of the largest full VSR K3
    call (the canonical images), and counts the rows K9 met and those
    whose image differs from the row."""

    def __init__(self):
        self.calls = {}
        self.rows = self.relabelled = 0

    keep = Recorder.keep

    def install(self):
        from tpuvsr_torch.engine.canon import CanonSpec
        from tpuvsr_torch.models.vsr_kernel import VSRKernel
        rec = self
        canon, full = CanonSpec.canonicalize, VSRKernel.fingerprint

        def p_canon(self, rows, out=None):
            rec.keep(self.kernel, rows.shape[0],
                     lambda: (self, rows.clone()))
            img = canon(self, rows, out)
            rec.rows += rows.shape[0]
            rec.relabelled += int((img != rows).any(dim=1).sum())
            return img

        def p_full(self, flat):
            rec.keep("vsr_fp_full", flat.shape[0],
                     lambda: (self, flat.clone()))
            return full(self, flat)
        CanonSpec.canonicalize, VSRKernel.fingerprint = p_canon, p_full

        def uninstall():
            CanonSpec.canonicalize, VSRKernel.fingerprint = canon, full
        return uninstall


def check_canon_kernels(rec):
    """Phase 8a: K9 bit for bit against its plain version, its images
    invariant under every group row, and K3's full fingerprint of the
    canonical images; each timed with its bound."""
    import torch
    out = []
    canon, rows = rec.calls["vsr_canon"][1]
    kern, pk = canon.kern, canon.kern.pk
    n, L = rows.shape
    got = canon.canonicalize(rows)
    err = max_abs(got, canon.canonicalize_plain(rows))
    for g in canon.tables(rows.device)["group"]:
        moved = pk.flatten(kern._permuted(pk.unflatten(rows), g))
        need(torch.equal(canon.canonicalize(moved), got),
             "K9's images are not invariant under the group")
    dst = torch.empty_like(rows)
    kernel_row(out, "vsr_canon",
               cuda_ms(lambda: canon.canonicalize(rows, dst)),
               cuda_ms(lambda: canon.canonicalize_plain(rows), reps=5), err,
               2 * n * L * 4, 0,
               extra={"shape": [n, L], "perms": canon.perms,
                      "key_lanes": int(canon.pos.shape[0])})
    kern, flat = rec.calls["vsr_fp_full"][1]
    B, L = flat.shape
    cols = kern.R * kern.nrep + kern.M * kern.nmsg
    kernel_row(out, "vsr_fp_full", cuda_ms(lambda: kern.fingerprint(flat)),
               cuda_ms(lambda: kern.fingerprint_plain(flat), reps=5),
               max_abs(kern.fingerprint(flat), kern.fingerprint_plain(flat)),
               B * L * 4 + B * 16, B * cols * 4 * 2,
               extra={"shape": [B, L]},
               label="vsr_fp_full (symmetric, canonical images)")
    torch.cuda.synchronize()
    return out


def symmetric_phase(args, doc):
    """Phase 8: the shipped model with symmetry on.  Returns its
    kernels-line rows, with the launch counts of the timed run_fused
    (8b)."""
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    from tpuvsr_torch.engine.spec import load_binding
    binding = load_binding(SHIPPED, "VSR")

    def engine(symmetry="auto"):
        return DeviceBFS(binding, tile_size=128, chunk_tiles=64,
                         fpset_capacity=1 << 26, device="cuda",
                         symmetry=symmetry)

    def pointers(eng):
        return [np.concatenate(getattr(eng, k))
                for k in ("_h_parent", "_h_action", "_h_param")]

    def no_incremental(counts, what):
        need(counts["vsr_canon"] > 0, f"K9 was not launched on {what}")
        need(counts["vsr_fp_parts"] == 0
             and counts["vsr_fp_incremental"] == 0,
             f"the incremental fingerprint was launched on {what}")

    d = SYM["record_depth"]
    print(f"phase 8a: shipped model, symmetry on, recording run() to depth "
          f"{d}", flush=True)
    rec = CanonRecorder()
    uninstall = rec.install()
    un_actions = record_actions(rec)
    kernels.reset_launch_counts()
    plain0 = plain_calls()
    eng = engine()
    t0 = time.time()
    res = eng.run(max_depth=d)
    torch.cuda.synchronize()
    uninstall()
    un_actions()
    counts = kernels.launch_counts()
    k10_only(counts, plain0, "the symmetric run()")
    doc["sym_record"] = {"wall_s": time.time() - t0, "levels": res.levels,
                         "launches": counts, "metrics": res.metrics,
                         "recorded": {k: v[0] for k, v in rec.calls.items()},
                         "canon_rows": rec.rows,
                         "canon_relabelled": rec.relabelled}
    need(res.ok and res.levels == SHIPPED_LEVELS[:d + 1],
         f"symmetric recording run levels {res.levels}")
    no_incremental(counts, "the symmetric run()")
    need(rec.relabelled > 0, "K9 relabelled no row in the recording run")
    run_pointers = pointers(eng)
    print(f"  levels {res.levels} in {doc['sym_record']['wall_s']:.3f}s; "
          f"K9 relabelled {rec.relabelled} of {rec.rows} rows", flush=True)
    del eng
    rows = check_canon_kernels(rec)
    check_actions(rows, rec.calls["vsr_actions"][1],
                  label="vsr_actions (shipped model, run() queue)")
    del rec

    d = SYM["depth"]
    print(f"phase 8b: run_fused, shipped model, symmetry on, to depth {d}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    plain0 = plain_calls()
    eng = engine()
    t0 = time.time()
    res = eng.run_fused(max_depth=d)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    k10_only(counts, plain0, "the symmetric run_fused")
    need(res.ok, f"symmetric path: {res.violated_invariant} {res.error}")
    need(res.levels == SHIPPED_LEVELS[:d + 1],
         f"symmetric path levels {res.levels}")
    need(res.distinct_states == sum(SHIPPED_LEVELS[:d + 1]),
         f"symmetric path distinct {res.distinct_states}")
    n12 = sum(SHIPPED_LEVELS[:SYM["record_depth"] + 1])
    same_pointers([a[:n12] for a in pointers(eng)], run_pointers,
                  res.levels[:SYM["record_depth"] + 1], "symmetric run_fused",
                  args)
    no_incremental(counts, "the symmetric run_fused")
    c, g = res.metrics["counters"], res.metrics["gauges"]
    need(c["host_reads"] == c["quanta"] + c.get("level_fits", 0),
         f"symmetric path host reads {c}")
    need(g["symmetry_perms"] == 2, f"symmetry_perms {g['symmetry_perms']}")
    sym = {"depth": d, "levels": res.levels,
           "distinct": res.distinct_states,
           "generated": res.states_generated, "wall_s": wall,
           "distinct_per_s": res.distinct_states / wall,
           "orbit_ratio": g["orbit_ratio"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts, "metrics": res.metrics}
    doc["symmetric"] = sym
    print(f"  levels {res.levels}, pointer tables through level "
          f"{SYM['record_depth']} equal to run()'s", flush=True)
    print(f"  distinct {res.distinct_states} generated "
          f"{res.states_generated} wall {wall:.3f}s distinct/s "
          f"{sym['distinct_per_s']:.1f} orbit_ratio {g['orbit_ratio']} "
          f"max_memory_allocated {sym['max_memory_allocated']}", flush=True)
    print(f"  host_reads {c.get('host_reads')} (quanta {c.get('quanta')}, "
          f"level fits {c.get('level_fits', 0)}) graph_replays "
          f"{c.get('graph_replays')} replays_after_stop "
          f"{c.get('replays_after_stop')} graph_captures "
          f"{c.get('graph_captures')} growth_pauses "
          f"{c.get('growth_pauses', 0)} tiles {c.get('tiles')}", flush=True)
    print(f"  launches {counts}", flush=True)
    for k in rows:
        k["launches"] = counts[k["kernel"]]
    del eng
    if args.profile:
        profile_quantum(doc, "profile_symmetric_quantum", engine(), 12)

    d = SYM["off_depth"]
    print(f"phase 8c: run_fused, shipped model, symmetry off, to depth {d}",
          flush=True)
    kernels.reset_launch_counts()
    plain0 = plain_calls()
    eng = engine(symmetry=False)
    t0 = time.time()
    res = eng.run_fused(max_depth=d)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    k10_only(counts, plain0, "the symmetry-off run_fused")
    need(res.ok and res.levels == SHIPPED_OFF_LEVELS[:d + 1],
         f"symmetry-off levels {res.levels}")
    need(counts["vsr_canon"] == 0 and counts["vsr_fp_incremental"] > 0,
         f"symmetry-off launches {counts}")
    doc["symmetric_off"] = {"depth": d, "levels": res.levels,
                            "distinct": res.distinct_states,
                            "generated": res.states_generated,
                            "wall_s": wall, "launches": counts,
                            "metrics": res.metrics}
    print(f"  levels {res.levels} distinct {res.distinct_states} wall "
          f"{wall:.3f}s orbit_ratio {res.metrics['gauges']['orbit_ratio']}",
          flush=True)
    del eng
    return rows


def triple_digest(fp, src, aid, dst):
    """Count and digest of an edge multiset labelled by fingerprint: rows
    (src fp, action, dst fp) of uint32 words (fingerprint word 0
    remapped 0 -> 1, as the FPSet keys it), sorted, then sha256 (the
    form of tests/test_torch_edges.py's record)."""
    import hashlib
    import numpy as np

    def keyed(f):
        k = np.array(f, np.uint32).reshape(-1, 4).copy()
        k[:, 0] = np.where(k[:, 0] == 0, 1, k[:, 0])
        return k
    rows = np.concatenate([keyed(fp[src]),
                           np.asarray(aid, np.uint32).reshape(-1, 1),
                           keyed(fp[dst])], axis=1)
    rows = rows[np.lexsort(rows.T[::-1])]
    return int(rows.shape[0]), hashlib.sha256(
        np.ascontiguousarray(rows).tobytes()).hexdigest()[:16]


class GidRecorder:
    """Counts calls of the plain versions of K11 and K12 and, with
    ``record``, keeps the inputs of the largest K11 store, K11 lookup
    and K12 call of the level pass (cloned: the engine reuses its
    buffers; each call reads its batch size back from the card, so a
    recording run is not timed)."""

    def __init__(self):
        self.calls = {}
        self.plain = {"store_gids": 0, "lookup_gids": 0, "emit_edges": 0}

    def install(self, record=True):
        from tpuvsr_torch.engine import device_bfs as D
        from tpuvsr_torch.engine import edges as E
        from tpuvsr_torch.engine import fpset as F
        rec = self
        store, lookup, emit = D.store_gids, D.lookup_gids, D.emit_edges
        plains = {"store_gids": (F, "store_gids_plain"),
                  "lookup_gids": (F, "lookup_gids_plain"),
                  "emit_edges": (E, "emit_edges_plain")}
        saved = {k: getattr(m, n) for k, (m, n) in plains.items()}

        def counting(key):
            def f(*a, **k):
                rec.plain[key] += 1
                return saved[key](*a, **k)
            return f
        for k, (m, n) in plains.items():
            setattr(m, n, counting(k))

        def uninstall():
            D.store_gids, D.lookup_gids, D.emit_edges = store, lookup, emit
            for k, (m, n) in plains.items():
                setattr(m, n, saved[k])
        if not record:
            return uninstall

        def keep(name, size, make):
            if size > self.calls.get(name, (-1, None))[0]:
                self.calls[name] = (size, make())

        def p_store(slots, vals, fps, gids, mask):
            keep("fpset_store_gids", int(mask.sum()), lambda: (
                fps.clone(), gids.clone(), mask.clone()))
            return store(slots, vals, fps, gids, mask)

        def p_lookup(table, vals, fps, mask):
            keep("fpset_probe", int(mask.sum()),
                 lambda: (fps.clone(), mask.clone()))
            return lookup(table, vals, fps, mask)

        def p_emit(eb, en, pidx, aid, dst, commit, src_off):
            keep("edge_emit", int((en & commit).sum()), lambda: (
                eb.cap, eb.n, en.clone(), pidx.clone(), aid.clone(),
                dst.clone(), commit.clone(), int(src_off)))
            return emit(eb, en, pidx, aid, dst, commit, src_off)
        D.store_gids, D.lookup_gids, D.emit_edges = p_store, p_lookup, p_emit
        return uninstall


def check_gid_kernels(rec, table):
    """Phase 9d: K11's store and probe (as lookup_gids and query_core)
    and K12 against their plain versions on the largest inputs of the
    recording edge run, on copies of its final table and gid column;
    each timed after an L2 flush.  A lane reads 16 bytes of a slot row
    (the claim word is not read)."""
    import torch
    from tpuvsr_torch.engine import edges as E
    from tpuvsr_torch.engine import fpset as F
    out = []
    dev = table["slots"].device
    evict = l2_evict(dev)
    slots = table["slots"]
    cap = slots.shape[0]

    # -- K11 store: the largest batch of fresh gids, stored again into a
    # copy of the column cleared at those slots
    fps, gids, mask = rec.calls["fpset_store_gids"][1]
    n, m = fps.shape[0], int(mask.sum())
    base = table["gids"].clone()
    hit = F.lookup_gids_plain(table, base, fps, mask)
    need(bool((hit[mask] == gids[mask]).all()),
         "the recorded store's gids are not in the final column")
    cleared = base.clone()
    cleared[F.lookup_gids_plain(table, torch.arange(
        cap, dtype=torch.int32, device=dev), fps, mask)[mask].long()] = -1
    va, vb = cleared.clone(), cleared.clone()
    F.store_gids(slots, va, fps, gids, mask)
    F.store_gids_plain(slots, vb, fps, gids, mask)
    torch.cuda.synchronize()
    err = max_abs(va, vb) + max_abs(va, base)
    kernel_row(out, "fpset_store_gids",
               cuda_ms(lambda: F.store_gids(slots, va, fps, gids, mask),
                       evict=evict),
               cuda_ms(lambda: F.store_gids_plain(slots, vb, fps, gids,
                                                  mask), reps=3, warm=1),
               err, n + 20 * m + 16 * m + 4 * m, 0,
               extra={"shape": [n, 4], "table_slots": cap, "masked": m})

    # -- K11 probe as lookup_gids: the largest lookup batch
    fps, mask = rec.calls["fpset_probe"][1]
    n, m = fps.shape[0], int(mask.sum())
    vals = table["gids"]
    a = F.lookup_gids(table, vals, fps, mask)
    b = F.lookup_gids_plain(table, vals, fps, mask)
    torch.cuda.synchronize()
    need(bool((a[mask] >= 0).all()), "a recorded lookup found no gid")
    kernel_row(out, "fpset_probe",
               cuda_ms(lambda: F.lookup_gids(table, vals, fps, mask),
                       evict=evict),
               cuda_ms(lambda: F.lookup_gids_plain(table, vals, fps, mask),
                       reps=3, warm=1),
               max_abs(a, b), n + 16 * m + 20 * m + 4 * n, 0,
               extra={"shape": [n, 4], "table_slots": cap, "masked": m,
                      "as": "lookup_gids"})
    # -- the same probe as query_core, on the same batch with half of it
    # replaced by fingerprints the table does not hold
    q = fps.clone()
    q[::2, 1] ^= 0x5A5A5A5A
    fa, oa = F.query_core(table, q, mask)
    fb, ob = F.query_core_plain(table, q, mask)
    torch.cuda.synchronize()
    need(oa == ob, "query_core overflow flag differs")
    need(bool(fa.any()), "the query batch found nothing fresh")
    kernel_row(out, "fpset_probe",
               cuda_ms(lambda: F.query_core(table, q, mask), evict=evict),
               cuda_ms(lambda: F.query_core_plain(table, q, mask), reps=3,
                       warm=1),
               max_abs(fa, fb), n + 16 * m + 16 * m + n + 4, 0,
               extra={"shape": [n, 4], "table_slots": cap, "masked": m,
                      "as": "query_core", "fresh": int(fa.sum())},
               label="fpset_probe (query_core)")

    # -- K12: the tile that appended the most edges
    e_cap, e_n, en, pidx, aid, dst, commit, src_off = rec.calls["edge_emit"][1]
    n = en.shape[0]
    ea, eb = E.EdgeBuffers(e_cap, dev), E.EdgeBuffers(e_cap, dev)
    ea.n = eb.n = e_n
    ka = E.emit_edges(ea, en, pidx, aid, dst, commit, src_off)
    kb = E.emit_edges_plain(eb, en, pidx, aid, dst, commit, src_off)
    torch.cuda.synchronize()
    k = int(kb)
    err = max(max_abs(ka, kb), max_abs(ea.src, eb.src),
              max_abs(ea.aid, eb.aid), max_abs(ea.dst, eb.dst))
    kernel_row(out, "edge_emit",
               cuda_ms(lambda: E.emit_edges(ea, en, pidx, aid, dst, commit,
                                            src_off), evict=evict),
               cuda_ms(lambda: E.emit_edges_plain(eb, en, pidx, aid, dst,
                                                  commit, src_off),
                       reps=5, warm=1),
               err, 13 * n + 1 + 12 * k + 4, 0,
               extra={"shape": [n], "appended": k, "edge_cap": e_cap})
    torch.cuda.synchronize()
    return out


def paged_phase(args, doc, binding, run_pointers):
    """Phase 9: the paged path, its disk tier and its edge stream.
    Returns the kernels-line rows of K11 and K12, with the launch counts
    of the timed edge run (9c)."""
    import tempfile
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.paged_bfs import PagedBFS
    levels = LEVELS[:args.depth + 1]
    base_kernels = ("fpset_insert", "dedup_batch", "vsr_fp_parts",
                    "vsr_fp_incremental", "pack", "unpack", "vsr_guards",
                    "compact", "vsr_actions")
    gid_kernels = ("fpset_store_gids", "fpset_probe", "edge_emit")

    def engine(**kw):
        return PagedBFS(binding, tile_size=128, chunk_tiles=64,
                        fpset_capacity=1 << 26,
                        next_capacity=PAGED["next_capacity"],
                        device="cuda", **kw)

    def timed(key, what, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        plain0 = plain_calls()
        eng = engine(**kw)
        t0 = time.time()
        res = eng.run(max_depth=args.depth)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        k10_only(counts, plain0, what)
        need(res.ok, f"{what}: {res.violated_invariant} {res.error}")
        need(res.levels == levels, f"{what} levels {res.levels}")
        need(res.distinct_states == sum(levels),
             f"{what} distinct {res.distinct_states}")
        need(res.states_generated == doc["main"]["generated"],
             f"{what} generated {res.states_generated}, run() "
             f"{doc['main']['generated']}")
        same_pointers([np.concatenate(getattr(eng, k))
                       for k in ("_h_parent", "_h_action", "_h_param")],
                      run_pointers, res.levels, what, args)
        for k in base_kernels:
            need(counts[k] > 0, f"{k} was not launched on {what}")
        need(counts["vsr_canon"] == 0, f"K9 was launched on {what}")
        c, g = res.metrics["counters"], res.metrics["gauges"]
        need(c["spill_count"] >= PAGED["min_drains"],
             f"{what}: {c['spill_count']} drains of a full next buffer")
        doc[key] = {"depth": args.depth, "levels": res.levels,
                    "distinct": res.distinct_states,
                    "generated": res.states_generated, "wall_s": wall,
                    "distinct_per_s": res.distinct_states / wall,
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated(),
                    "launches": counts, "metrics": res.metrics}
        print(f"  levels {res.levels}, counts and pointer tables equal to "
              f"run()'s", flush=True)
        print(f"  wall {wall:.3f}s distinct/s "
              f"{doc[key]['distinct_per_s']:.1f} drains {c['drains']} (full "
              f"buffer {c['spill_count']}) chunks {c['chunks']} host copies "
              f"{g['host_copy_s']:.4f}s max_memory_allocated "
              f"{doc[key]['max_memory_allocated']}", flush=True)
        print(f"  launches {counts}", flush=True)
        return eng, res, counts

    print(f"phase 9a: PagedBFS, defect config to depth {args.depth}",
          flush=True)
    eng, res, counts = timed("paged", "the paged path")
    for k in gid_kernels:
        need(counts[k] == 0, f"{k} was launched without edges")
    del eng

    print(f"phase 9b: PagedBFS with the disk tier, depth {args.depth}",
          flush=True)
    with tempfile.TemporaryDirectory() as d:
        eng, res, counts = timed("paged_disk", "the disk tier",
                                 spill_dir=d,
                                 spill_ram_rows=PAGED["spill_ram_rows"])
        c, g = res.metrics["counters"], res.metrics["gauges"]
        need(c["spill_tier_flushes"] > 0, "the disk tier wrote no page")
        need(os.listdir(d) == [], f"disk tier files left: {os.listdir(d)}")
        print(f"  disk tier: {c['spill_tier_flushes']} page files, "
              f"{g['spill_tier_bytes']} bytes", flush=True)
        del eng

    print(f"phase 9c: PagedBFS(edges=True), depth {args.depth}", flush=True)
    plain = GidRecorder()
    uninstall = plain.install(record=False)
    try:
        eng, res, counts = timed("paged_edges", "the edge stream",
                                 edges=True, retain_levels=True,
                                 edge_capacity=PAGED["edge_capacity"])
    finally:
        uninstall()
    need(res.metrics["counters"].get("edge_flushes", 0) > 0,
         "no tile found the edge buffers full (R_EDGE_FLUSH)")
    for k in gid_kernels:
        need(counts[k] > 0, f"{k} was not launched on the edge stream")
    need(sum(plain.plain.values()) == 0,
         f"the plain K11/K12 versions ran on the edge stream: {plain.plain}")
    n = res.distinct_states
    t0 = time.time()
    indptr, aid, tid = eng.edge_sink.finalize(n)
    csr_s = time.time() - t0
    src = np.repeat(np.arange(n), np.diff(indptr))
    need(bool((tid >= 0).all() and (tid < n).all()),
         "an edge's destination gid lies outside [0, distinct)")
    need(int(indptr[-1]) == res.metrics["gauges"]["edge_rows"],
         "the CSR lost edges")
    # out-degree = enabled lanes of K6's guard matrix, expanded levels
    deg = []
    for blk in eng.level_blocks:
        rows = next(iter(blk.values())).shape[0]
        for lo in range(0, rows, 1 << 16):
            flat = eng._pk.flatten({k: torch.as_tensor(
                v[lo:lo + (1 << 16)], device="cuda")
                for k, v in blk.items()}).contiguous()
            en, _any = eng._guards(flat)
            deg.append(en.sum(dim=1).cpu().numpy())
    deg = np.concatenate(deg)
    n_exp = deg.shape[0]
    need(n_exp == sum(levels[:-1]), f"retained {n_exp} expanded states")
    need(np.array_equal(np.diff(indptr)[:n_exp], deg)
         and not np.diff(indptr)[n_exp:].any(),
         "an out-degree differs from the state's enabled lanes")
    # every trace-pointer edge (parent, action, gid) is an edge
    par = np.concatenate(eng._h_parent)
    act = np.concatenate(eng._h_action)
    n0 = levels[0]
    key = lambda p, a, d: (np.asarray(p, np.int64) << 32) \
        | (np.asarray(a, np.int64) << 24) | np.asarray(d, np.int64)
    need(bool(np.isin(key(par[n0:], act[n0:], np.arange(n0, n)),
                      key(src, aid, tid)).all()),
         "a trace-pointer edge is missing from the graph")
    # gid -> fingerprint from the gid column, on the card
    slots, gids = eng.table["slots"], eng.table["gids"]
    occ = torch.nonzero((slots[:, 0] != 0) & (gids >= 0)).squeeze(1)
    fp_dev = torch.zeros((n, 4), dtype=torch.int32, device="cuda")
    fp_dev[gids[occ].long()] = slots[occ, :4]
    need(occ.numel() == n, f"{occ.numel()} gids stored for {n} states")
    fp = fp_dev.cpu().numpy().view(np.uint32)
    upto = sum(levels[:EDGE_RECORD["depth"]])
    need(upto == EDGE_RECORD["sources"], f"{upto} sources")
    sel = src < upto
    count, digest = triple_digest(fp, src[sel], aid[sel], tid[sel])
    need((count, digest) == (EDGE_RECORD["edges"], EDGE_RECORD["digest"]),
         f"edge multiset out of levels 0-{EDGE_RECORD['depth'] - 1}: "
         f"{count} edges, digest {digest}; the JAX record {EDGE_RECORD}")
    g = res.metrics["gauges"]
    # phase 15e's comparison: the edges out of its levels
    d15 = min(PER_ACTION["paged_depth"], args.depth)
    to15 = src < sum(levels[:d15])
    doc["paged_edges"].update(edges=int(indptr[-1]), csr_s=csr_s,
                              record=[count, digest],
                              per_action_depth=d15,
                              edges_to_depth=triple_digest(
                                  fp, src[to15], aid[to15], tid[to15]))
    print(f"  {int(indptr[-1])} edges ({g['edges_per_s']} /s), edge drains "
          f"{res.metrics['counters']['edge_drains']} (flushes "
          f"{res.metrics['counters'].get('edge_flushes', 0)}), buffer high "
          f"water {g['edge_buf_high_water']}, CSR in {csr_s:.3f}s; "
          f"out-degrees, pointer edges and the depth-"
          f"{EDGE_RECORD['depth']} record ({count} edges, {digest}) hold",
          flush=True)

    # the two-pass graph over the same retained levels: its index covers
    # levels 0-7 and its edge pass expands levels 0-6
    from tpuvsr_torch.engine.device_liveness import two_pass_prefix
    d = EDGE_RECORD["depth"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain0 = plain_calls()
    uninstall = plain.install(record=False)
    try:
        t0 = time.time()
        indptr2, aid2, tid2 = two_pass_prefix(eng, d)
        torch.cuda.synchronize()
        two_s = time.time() - t0
    finally:
        uninstall()
    counts2 = kernels.launch_counts()
    k10_only(counts2, plain0, "the two-pass edge pass")
    for k in ("fpset_insert", "fpset_store_gids", "fpset_probe",
              "vsr_guards", "compact", "vsr_fp_full"):
        need(counts2[k] > 0, f"{k} was not launched on the two-pass graph")
    need(counts2["edge_emit"] == 0, "K12 was launched on the two-pass graph")
    need(sum(plain.plain.values()) == 0,
         f"the plain K11/K12 versions ran on the two-pass graph: "
         f"{plain.plain}")
    need(len(indptr2) == n_exp + 1, "the two-pass CSR is not over the "
         "retained states")
    src2 = np.repeat(np.arange(n_exp), np.diff(indptr2))

    def triples(s_, a_, t_):
        t = np.stack([s_, np.asarray(a_, np.int64),
                      np.asarray(t_, np.int64)], axis=1)
        return t[np.lexsort(t.T[::-1])]
    need(np.array_equal(triples(src2, aid2, tid2),
                        triples(src[sel], aid[sel], tid[sel])),
         f"the two-pass graph out of levels 0-{d - 1} differs from the "
         f"streamed one")
    need(triple_digest(fp, src2, aid2, tid2) == (count, digest),
         "the two-pass graph misses the JAX record")
    doc["two_pass"] = {"index_levels": d + 1, "edge_levels": d,
                       "edges": int(indptr2[-1]), "wall_s": two_s,
                       "launches": counts2}
    print(f"  two-pass graph (index levels 0-{d}, edges out of levels "
          f"0-{d - 1}): {int(indptr2[-1])} edges in {two_s:.3f}s, equal to "
          f"the streamed ones; launches {counts2}", flush=True)

    print("phase 19c: K18 over the levels 9c retains (the expanded ones), "
          "every VSR predicate, against its plain version", flush=True)
    t0 = time.time()
    n19, holds, big = k18_over_blocks(eng, "19c")
    need(n19 == n_exp, f"19c: {n19} rows of {n_exp}")
    k18_rows = []
    k18_row(k18_rows, eng.kern, big, doc["main"]["launches"][
        "vsr_state_pred"], "vsr_state_pred (19c, a batch of 9c's levels)")
    doc["k18_vsr"] = {"rows": n19, "holds": holds,
                      "wall_s": time.time() - t0}
    print(f"  {n19} states: where each predicate holds {holds}",
          flush=True)
    del eng, big

    print("phase 9d: K11 and K12 against their plain versions", flush=True)
    rec = GidRecorder()
    uninstall = rec.install()
    try:
        eng = engine(edges=True, edge_capacity=PAGED["edge_capacity"])
        rres = eng.run(max_depth=args.depth)
    finally:
        uninstall()
    need(rres.levels == levels, f"recording edge run levels {rres.levels}")
    doc["gid_recorded"] = {k: v[0] for k, v in rec.calls.items()}
    rows = check_gid_kernels(rec, eng.table)
    for r in rows:
        # query_core has no caller on the path: the probe kernel's
        # launches there are lookup_gids'
        r["launches"] = (0 if r.get("as") == "query_core"
                         else counts[r["kernel"]])
    rows += k18_rows
    del eng, rec

    print("phase 9e: the Ticker stub's behaviour graph, stream and "
          "two-pass", flush=True)
    from tpuvsr_torch.engine.device_liveness import DeviceGraph
    from tpuvsr_torch.testing import (canon_csr, stub_ticker_factory,
                                      ticker_binding)

    def graph(mode, device):
        return canon_csr(DeviceGraph(
            ticker_binding(modulus=6), mode=mode, tile_size=4,
            chunk_tiles=2, next_capacity=32, fpset_capacity=1 << 8,
            device=device, model_factory=stub_ticker_factory(6)))
    want = graph("stream", "cpu")
    need(graph("stream", "cuda") == want, "the streamed Ticker graph "
         "differs from the plain versions' on the CPU")
    need(graph("two-pass", "cuda") == want, "the two-pass Ticker graph "
         "differs from the streamed one")
    print(f"  12 states, {sum(map(len, want))} edges: stream == two-pass",
          flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        eng = engine(edges=True, edge_capacity=PAGED["edge_capacity"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            eng.run(max_depth=min(args.depth, 9))
            torch.cuda.synchronize()
            wall = time.time() - t0
        dev_us = device_us(prof)
        doc["profile_paged_edges"] = {
            "depth": min(args.depth, 9), "wall_s": wall,
            "device_s": dev_us / 1e6, "device_busy_share": dev_us / 1e6 / wall,
            "table": prof.key_averages().table(sort_by="cuda_time_total",
                                               row_limit=40)}
        print(f"  profiled paged edge run to depth {min(args.depth, 9)}: "
              f"wall {wall:.3f}s, device busy {dev_us / 1e6:.3f}s",
              flush=True)
        del eng
    return rows


class ST03Recorder:
    """Keeps, during a run on a model of the ST03 family, the inputs of
    the largest call of K13 (rows), K14 (queue items) and K3's three
    kernels, cloned before the call, under the model's KERNELS names
    (``GUARDS_KERNEL``, ``ACTIONS_KERNEL``, ``FP_KERNELS``).  With
    ``by_action`` it also keeps, under (kernel name, action name), the
    inputs of the K13 and K14 call in which that action's lanes were
    enabled most, and sums each action's enabled lanes in ``enabled``
    (a host read a call)."""

    def __init__(self, by_action=False):
        self.calls = {}
        self.by_action = by_action
        self.enabled = {}

    keep = Recorder.keep

    def keep_by_action(self, name, kern, counts, make):
        snap = []
        for a, c in zip(kern.action_names, counts.tolist()):
            key = (name, a)
            self.enabled[key] = self.enabled.get(key, 0) + c
            if c > self.calls.get(key, (0, None))[0]:
                if not snap:
                    snap.append(make())
                self.calls[key] = (c, snap[0])

    def install(self):
        import torch
        from tpuvsr_torch.models.st03_kernel import ST03Kernel as K
        rec = self
        saved = {n: getattr(K, n) for n in (
            "guard_matrix", "successors", "parent_parts", "fingerprint",
            "fingerprint_incremental")}

        def guards(self, flat, out=None, halt=None):
            rec.keep(self.GUARDS_KERNEL[0], flat.shape[0],
                     lambda: (self, flat.clone()))
            res = saved["guard_matrix"](self, flat, out, halt)
            if rec.by_action:
                la = torch.as_tensor(self.lane_action, device=flat.device)
                counts = torch.zeros(len(self.action_names), dtype=torch.long,
                                     device=flat.device).index_add_(
                    0, la.long(), res[0].sum(dim=0))
                rec.keep_by_action(self.GUARDS_KERNEL[0], self, counts,
                                   lambda: (self, flat.clone()))
            return res

        def succs(self, flat, pidx, aid, lane, mask, out=None, halt=None):
            def snap():
                return (self, flat.clone(), pidx.clone(), aid.clone(),
                        lane.clone(), mask, None)
            rec.keep(self.ACTIONS_KERNEL[0], pidx.shape[0], snap)
            res = saved["successors"](self, flat, pidx, aid, lane, mask,
                                      out, halt)
            if rec.by_action:
                counts = torch.bincount(aid.long()[res["en2"]],
                                        minlength=len(self.action_names))
                rec.keep_by_action(self.ACTIONS_KERNEL[0], self, counts,
                                   snap)
            return res

        def parts(self, flat):
            rec.keep(self.FP_KERNELS["parts"], flat.shape[0],
                     lambda: (self, flat.clone()))
            return saved["parent_parts"](self, flat)

        def full(self, flat):
            rec.keep(self.FP_KERNELS["full"], flat.shape[0],
                     lambda: (self, flat.clone()))
            return saved["fingerprint"](self, flat)

        def incr(self, succ, ri, ts, pidx, parent, prt):
            rec.keep(self.FP_KERNELS["incremental"], succ.shape[0],
                     lambda: (self, succ.clone(), ri.clone(), ts.clone(),
                              pidx.clone(), parent.clone(),
                              tuple(x.clone() for x in prt)))
            return saved["fingerprint_incremental"](self, succ, ri, ts, pidx,
                                                    parent, prt)
        for n, f in (("guard_matrix", guards), ("successors", succs),
                     ("parent_parts", parts), ("fingerprint", full),
                     ("fingerprint_incremental", incr)):
            setattr(K, n, f)

        def uninstall():
            for n, f in saved.items():
                setattr(K, n, f)
        return uninstall


def check_family_coverage(rec, K, what, idle=("NoProgressChange",)):
    """Phases 11e and 12e: on the K13 and K14 calls that a ``by_action``
    recording run kept for each action, K13, K14 (under each invariant
    of ``INVARIANT_FNS`` alone, so an invariant the cfg leaves out is
    held too) and K3's full fingerprint of K14's successors bit for bit
    against their plain versions.  Every action but those of ``idle``
    (NoProgressChange: NoProgressChangeLimit 0 disables it) must have
    been enabled in both kernels' kept inputs.  Returns each action's
    enabled lanes."""
    g_name, a_name = K.GUARDS_KERNEL[0], K.ACTIONS_KERNEL[0]
    masks = [1 << b for b in range(len(K.INVARIANT_FNS))]
    for (name, act), (c, call) in sorted(
            (k, v) for k, v in rec.calls.items() if isinstance(k, tuple)):
        if name == g_name:
            kern, flat = call
            a, p = kern.guard_matrix(flat), kern.guard_matrix_plain(flat)
            need(max(max_abs(a[0], p[0]), max_abs(a[1], p[1])) == 0,
                 f"{what}: {g_name} differs from its plain version on the "
                 f"call where {act} was enabled {c} times")
            continue
        kern, flat, pidx, aid, lane, cfg_mask, _ok = call
        for m in [cfg_mask] + masks:
            a = kern.successors(flat, pidx, aid, lane, m)
            p = kern.successors_plain(flat, pidx, aid, lane, m)
            bad = [k for k in a if max_abs(a[k], p[k]) != 0]
            need(not bad, f"{what}: {a_name} differs from its plain version "
                 f"in {bad} (invariant mask {m}) on the queue where {act} "
                 f"was enabled {c} times")
        check_k18_succ(kern, flat, pidx, aid, lane,
                       f"{what} (19d), the queue where {act} was enabled "
                       f"{c} times")
        need(max_abs(kern.fingerprint(a["succ"]),
                     kern.fingerprint_plain(a["succ"])) == 0,
             f"{what}: {K.FP_KERNELS['full']} differs from its plain "
             f"version on the successors of the queue where {act} was "
             f"enabled {c} times")
    enabled = {n: {a: rec.enabled.get((n, a), 0) for a in K.action_names}
               for n in (g_name, a_name)}
    for n, per in enabled.items():
        never = [a for a, c in per.items() if c == 0 and a not in idle]
        need(not never, f"{what}: {never} never enabled in {n}'s inputs")
    return enabled


def st03_plain_calls():
    """Calls of the plain ST03 guard and action functions so far (their
    doors, ST03Kernel._guard_fns and _action_fns)."""
    from tpuvsr_torch.models.st03_kernel import PLAIN_CALLS
    return dict(PLAIN_CALLS)


def check_st03_kernels(rec, kern_cls=None):
    """Phases 10b and 11b: K13, K14 and K3 of a model of the ST03 family
    (``kern_cls``, ST03Kernel by default) bit for bit against their
    plain versions on the inputs its recording run kept, each timed after
    an L2 flush with its bound."""
    import numpy as np
    import torch
    from tpuvsr_torch.models.st03_kernel import ST03Kernel
    K = kern_cls or ST03Kernel
    g_name, a_name = K.GUARDS_KERNEL[0], K.ACTIONS_KERNEL[0]
    out = []
    kern, flat = rec.calls[g_name][1]
    dev = flat.device
    evict = l2_evict(dev)
    B = flat.shape[0]
    a, p = kern.guard_matrix(flat), kern.guard_matrix_plain(flat)
    err = max(max_abs(a[0], p[0]), max_abs(a[1], p[1]))
    span = {k: e - s for k, _sh, s, e in kern.pk._splits}
    lanes_read = sum(span[k] for k in kern.GUARD_KEYS if k in span)
    scans = [kern.action_names.index(n) for n in ("SendGetState",
                                                  "ResendSVC")
             if n in kern.action_names]
    sgs = torch.as_tensor(np.isin(kern.lane_action, scans), device=dev)
    n_scan = int(a[0][:, sgs].sum())
    # ten operations a lane, SendDVC's and SendSV's quorum counts (six
    # compares a slot, 2R lanes a row) and the bag scans of the enabled
    # SendGetState (SendOnce: a header, an entry and a log a slot) and
    # ResendSVC lanes
    nops = (10 * B * kern.n_lanes + 6 * kern.M * 2 * kern.R * B
            + (kern.NHDR + kern.MAX_OPS + 2) * kern.M * n_scan)
    kernel_row(out, g_name,
               cuda_ms(lambda: kern.guard_matrix(flat), evict=evict),
               cuda_ms(lambda: kern.guard_matrix_plain(flat), reps=5), err,
               B * lanes_read * 4 + B * kern.n_lanes + B, nops,
               extra={"shape": [B, kern.pk.lanes], "n_lanes": kern.n_lanes,
                      "enabled": int(a[0].sum()), "bag_scans": n_scan})
    check_actions(out, rec.calls[a_name][1], name=a_name)
    k_a, flat_a, pidx, aid, lane = rec.calls[a_name][1][:5]
    check_k18_succ(k_a, flat_a, pidx, aid, lane,
                   f"{a_name}'s recorded queue (19d)")
    fp_rows(out, rec.calls, K.FP_KERNELS, evict=evict)
    # the full fingerprint at a tile's width (the recorded call is the
    # Init row): the successors of the recorded incremental call
    full = K.FP_KERNELS["full"]
    kern, succ = rec.calls[K.FP_KERNELS["incremental"]][1][:2]
    n, L = succ.shape
    cols = kern.R * kern.nrep + kern.M * kern.nmsg + kern.nglob
    kernel_row(out, full,
               cuda_ms(lambda: kern.fingerprint(succ), evict=evict),
               cuda_ms(lambda: kern.fingerprint_plain(succ), reps=5),
               max_abs(kern.fingerprint(succ), kern.fingerprint_plain(succ)),
               n * L * 4 + n * 16, n * cols * 4 * 2,
               extra={"shape": [n, L]},
               label=f"{full} (a tile's successors)")
    torch.cuda.synchronize()
    return out


def st03_phase(args, doc):
    """Phase 10: VR_STATE_TRANSFER (ST03) on the card.  Returns its
    kernels-line rows, with the launch counts of the timed run_fused on
    the small cfg (10c)."""
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    from tpuvsr_torch.engine.spec import load_binding

    def engine(cfg):
        return DeviceBFS(load_binding(cfg, "VR_STATE_TRANSFER"),
                         tile_size=128, chunk_tiles=64,
                         fpset_capacity=1 << 26, device="cuda")

    def pointers(eng):
        return [np.concatenate(getattr(eng, k))
                for k in ("_h_parent", "_h_action", "_h_param")]

    def timed(cfg, entry, depth=None):
        """One run, launch counts reset just before and read just after;
        K13, K14 and K3 (parts, incremental) launched, the VSR kernels
        and the plain ST03 functions not."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        plain0 = st03_plain_calls()
        eng = engine(cfg)
        t0 = time.time()
        res = getattr(eng, entry)(max_depth=depth)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        what = f"ST03 {os.path.basename(cfg)} {entry}"
        for k in ("st03_guards", "st03_actions", "st03_fp_parts",
                  "st03_fp_incremental", "st03_fp_full"):
            need(counts[k] > 0, f"{k} was not launched on {what}")
        for k in ("vsr_guards", "vsr_actions", "vsr_canon", "vsr_fp_parts",
                  "vsr_fp_full", "vsr_fp_incremental"):
            need(counts[k] == 0, f"{k} was launched on {what}")
        if entry == "run_fused":
            for k in ("compact", "commit_prefix", "commit_finish",
                      "level_step"):
                need(counts[k] > 0, f"{k} was not launched on {what}")
        need(st03_plain_calls() == plain0, f"the plain ST03 functions ran "
             f"on {what}: {plain0} -> {st03_plain_calls()}")
        need(res.ok, f"{what}: {res.violated_invariant} {res.error}")
        c = res.metrics["counters"]
        info = {"levels": res.levels, "distinct": res.distinct_states,
                "generated": res.states_generated,
                "diameter": res.diameter, "wall_s": wall,
                "distinct_per_s": res.distinct_states / wall,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "launches": counts, "metrics": res.metrics}
        print(f"  {entry}: distinct {res.distinct_states} generated "
              f"{res.states_generated} diameter {res.diameter} wall "
              f"{wall:.3f}s distinct/s {info['distinct_per_s']:.1f} "
              f"max_memory_allocated {info['max_memory_allocated']}",
              flush=True)
        print(f"  host_reads {c.get('host_reads')} graph_captures "
              f"{c.get('graph_captures')} growth_pauses "
              f"{c.get('growth_pauses', 0)} tiles {c.get('tiles')} "
              f"max_msgs {res.metrics['gauges']['max_msgs']}", flush=True)
        return eng, res, info

    def fixpoint(res, what):
        need(res.levels == ST03_SMALL_LEVELS, f"{what} levels {res.levels}")
        need((res.distinct_states, res.states_generated, res.diameter)
             == ST03_FIXPOINT, f"{what}: {res.distinct_states} distinct, "
             f"{res.states_generated} generated, diameter {res.diameter}")
        need(res.error is None, f"{what}: {res.error}")

    print("phase 10a: ST03 small cfg, recording run() to its fixpoint",
          flush=True)
    rec = ST03Recorder()
    uninstall = rec.install()
    try:
        eng, res, info = timed(ST03_SMALL, "run")
    finally:
        uninstall()
    fixpoint(res, "ST03 recording run()")
    info["recorded"] = {k: v[0] for k, v in rec.calls.items()}
    doc["st03_record"] = info
    run_pointers = pointers(eng)
    del eng
    print("phase 10b: K13, K14, K3 on ST03 against their plain versions",
          flush=True)
    rows = check_st03_kernels(rec)
    del rec

    print("phase 10c: run_fused, ST03 small cfg to its fixpoint",
          flush=True)
    eng, res, info = timed(ST03_SMALL, "run_fused")
    fixpoint(res, "ST03 run_fused")
    same_pointers(pointers(eng), run_pointers, res.levels, "ST03 run_fused",
                  args)
    c = res.metrics["counters"]
    need(c["host_reads"] == c["quanta"] + c.get("level_fits", 0),
         f"ST03 fused host reads {c}")
    doc["st03_fused"] = info
    print(f"  levels {res.levels}, pointer tables equal to 10a's",
          flush=True)
    print(f"  launches {info['launches']}", flush=True)
    for k in rows:
        k["launches"] = info["launches"][k["kernel"]]
    del eng

    d, rd = ST03_SHIPPED_DEPTH, ST03_SHIPPED_RUN_DEPTH
    rec_d = len(ST03_SHIPPED_LEVELS) - 1
    print(f"phase 10d: ST03 shipped cfg, run_fused to depth {d} and run() "
          f"to depth {rd}", flush=True)
    _e, fres, finfo = timed(ST03_SHIPPED, "run_fused", d)
    del _e
    _e, rres, rinfo = timed(ST03_SHIPPED, "run", rd)
    del _e
    need(fres.levels[:rec_d + 1] == ST03_SHIPPED_LEVELS,
         f"ST03 shipped levels {fres.levels[:rec_d + 1]}")
    need(fres.levels[:rd + 1] == rres.levels and len(fres.levels) == d + 1
         and len(rres.levels) == rd + 1,
         f"ST03 shipped run_fused levels {fres.levels}, run() "
         f"{rres.levels}")
    need(rres.distinct_states == sum(fres.levels[:rd + 1]),
         f"ST03 shipped run() distinct {rres.distinct_states}")
    doc["st03_shipped"] = {"depth": d, "run_depth": rd,
                           "run_fused": finfo, "run": rinfo}
    print(f"  levels {fres.levels} (the JAX record through depth {rec_d})",
          flush=True)
    return rows


def family_kernels():
    """{model: its K13, K14 and K3 kernel names} for ST03, every model
    of FAMILY and RECOVERY, and CP06."""
    from tpuvsr_torch.models.registry import _resolve
    out = {}
    for m, fam in [("ST03", {"module": "VR_STATE_TRANSFER"})] + list(
            FAMILY.items()) + list(RECOVERY.items()) + [("CP06",
                                                          CHECKPOINT)]:
        K = _resolve(fam["module"])[1]
        out[m] = [K.GUARDS_KERNEL[0], K.ACTIONS_KERNEL[0],
                  *K.FP_KERNELS.values()]
    return out


VSR_KERNELS = ["vsr_guards", "vsr_actions", "vsr_canon", "vsr_fp_parts",
               "vsr_fp_full", "vsr_fp_incremental", "vsr_state_pred"]


def family_canon_kernels():
    """{model: the name its K9 launches count under}, as family_kernels."""
    from tpuvsr_torch.models.registry import _resolve
    return {m: _resolve(module)[1].CANON_KERNEL
            for m, (module, _size) in FAMILY_SYMMETRY.items()}


def family_cfg(module, size):
    return os.path.join(ROOT, "tpuvsr_torch", "configs",
                        f"{module}_{size}.cfg")


def trace_pointers(eng):
    import numpy as np
    return [np.concatenate(getattr(eng, k))
            for k in ("_h_parent", "_h_action", "_h_param")]


def model_run(m, module, size, entry, depth=None, constants=None,
              log=None, label=None, setup=None, violation=None,
              invariants=None, engine_cls=None, **engine_kw):
    """One run of the family model ``m`` on its ``size`` cfg (cfg
    constants overridden by ``constants``; ``setup(engine)``, when given,
    installs a probe and returns its removal), launch counts reset just
    before and read just after: the model's K13, K14 and K3 (parts,
    incremental) launched, the other models' kernels, the VSR kernels and
    the plain functions of the family not; no K9.  With symmetry on (a
    ``_symmetry`` cfg) the model's K9 and full K3 launch instead of the
    incremental K3, and the group has order 2.  The run must end without
    a violation, or with the invariant ``violation``.  Returns (engine,
    result, info).  ``invariants``, when given, replaces the cfg's
    INVARIANT list; ``engine_cls`` (DeviceBFS by default) and
    ``engine_kw`` build the engine."""
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    from tpuvsr_torch.engine.spec import load_binding
    model_kernels = family_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    plain0 = st03_plain_calls()
    b = load_binding(family_cfg(module, size), module)
    b.cfg.constants.update(constants or {})
    if invariants is not None:
        b.invariants = list(invariants)
    eng = (engine_cls or DeviceBFS)(b, tile_size=128, chunk_tiles=64,
                                    fpset_capacity=1 << 26, device="cuda",
                                    **engine_kw)
    undo = setup(eng) if setup else None
    try:
        t0 = time.time()
        res = getattr(eng, entry)(max_depth=depth, log=log)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        if undo:
            undo()
    counts = kernels.launch_counts()
    what = f"{label or m + ' ' + size} {entry}"
    need(type(eng.kern).__name__ == f"{m}Kernel",
         f"{what} ran on {type(eng.kern).__name__}")
    K = type(eng.kern)
    canons = [c for o, c in family_canon_kernels().items() if o != m]
    if eng._canon is None:
        used, unused = model_kernels[m], [K.CANON_KERNEL]
    else:
        used = [K.GUARDS_KERNEL[0], K.ACTIONS_KERNEL[0],
                K.FP_KERNELS["full"], K.CANON_KERNEL]
        unused = [K.FP_KERNELS["parts"], K.FP_KERNELS["incremental"]]
        need(res.metrics["gauges"]["symmetry_perms"] == 2,
             f"{what}: symmetry_perms "
             f"{res.metrics['gauges']['symmetry_perms']}")
    for k in used:
        need(counts[k] > 0, f"{k} was not launched on {what}")
    others = [k for o, ks in model_kernels.items() if o != m
              for k in ks] + VSR_KERNELS + canons + unused
    for k in others:
        need(counts[k] == 0, f"{k} was launched on {what}")
    if engine_kw.get("commit") == "per-action":
        # the per-action commit: K15 an action, no fused K8 commit
        for k in ("compact", "action_gate", "action_finish"):
            need(counts[k] > 0, f"{k} was not launched on {what}")
        for k in ("commit_prefix", "commit_finish"):
            need(counts[k] == 0, f"{k} was launched on {what}")
        if entry == "run_fused":
            need(counts["level_step"] > 0,
                 f"level_step was not launched on {what}")
    elif entry == "run_fused":
        for k in ("compact", "commit_prefix", "commit_finish",
                  "level_step"):
            need(counts[k] > 0, f"{k} was not launched on {what}")
    need(st03_plain_calls() == plain0, f"the plain family functions "
         f"ran on {what}: {plain0} -> {st03_plain_calls()}")
    need(res.ok if violation is None else
         res.violated_invariant == violation,
         f"{what}: {res.violated_invariant} {res.error}")
    c = res.metrics["counters"]
    info = {"levels": res.levels, "distinct": res.distinct_states,
            "generated": res.states_generated,
            "diameter": res.diameter, "wall_s": wall,
            "distinct_per_s": res.distinct_states / wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "orbit_ratio": res.metrics["gauges"].get("orbit_ratio"),
            "launches": counts, "metrics": res.metrics,
            "violated": res.violated_invariant}
    print(f"  {what}: distinct {res.distinct_states} generated "
          f"{res.states_generated} diameter {res.diameter} wall "
          f"{wall:.3f}s distinct/s {info['distinct_per_s']:.1f} "
          f"max_memory_allocated {info['max_memory_allocated']}"
          + (f" orbit_ratio {info['orbit_ratio']}"
             if eng._canon is not None else ""), flush=True)
    print(f"    host_reads {c.get('host_reads')} graph_captures "
          f"{c.get('graph_captures')} growth_pauses "
          f"{c.get('growth_pauses', 0)} tiles {c.get('tiles')} "
          f"max_msgs {res.metrics['gauges']['max_msgs']}", flush=True)
    return eng, res, info


def fused_host_reads(res, what):
    c = res.metrics["counters"]
    need(c["host_reads"] == c["quanta"] + c.get("level_fits", 0),
         f"{what} fused host reads {c}")


def family_phase(args, doc):
    """Phase 11: A01, I01 and AS04, the family's models on ST03's kernels,
    on the card.  Returns their kernels-line rows, with the launch counts
    of each model's timed run_fused on its small cfg (11c)."""
    from tpuvsr_torch.models.registry import _resolve

    def timed(m, size, entry, depth=None):
        return model_run(m, FAMILY[m]["module"], size, entry, depth)

    def fixpoint(m, res, what):
        fam = FAMILY[m]
        need(res.levels == fam["small"], f"{what} levels {res.levels}")
        need((res.distinct_states, res.states_generated, res.diameter)
             == fam["fixpoint"], f"{what}: {res.distinct_states} distinct, "
             f"{res.states_generated} generated, diameter {res.diameter}")
        need(res.error is None, f"{what}: {res.error}")

    rows = []
    out = doc.setdefault("family", {})
    for m, fam in FAMILY.items():
        K = _resolve(fam["module"])[1]
        info_m = out.setdefault(m, {})
        print(f"phase 11a: {m} small cfg, recording run() to its fixpoint",
              flush=True)
        rec = ST03Recorder()
        uninstall = rec.install()
        try:
            eng, res, info = timed(m, "small", "run")
        finally:
            uninstall()
        fixpoint(m, res, f"{m} recording run()")
        info["recorded"] = {k: v[0] for k, v in rec.calls.items()}
        info_m["record"] = info
        run_pointers = trace_pointers(eng)
        del eng
        print(f"phase 11b: K13, K14, K3 on {m} against their plain "
              f"versions", flush=True)
        mrows = check_st03_kernels(rec, K)
        del rec

        print(f"phase 11c: run_fused, {m} small cfg to its fixpoint",
              flush=True)
        eng, res, info = timed(m, "small", "run_fused")
        fixpoint(m, res, f"{m} run_fused")
        same_pointers(trace_pointers(eng), run_pointers, res.levels,
                      f"{m} run_fused", args)
        fused_host_reads(res, m)
        info_m["fused"] = info
        print(f"  levels {res.levels}, pointer tables equal to 11a's",
              flush=True)
        for k in mrows:
            k["launches"] = info["launches"][k["kernel"]]
        rows += mrows
        del eng

        fd, rd = FAMILY_FUSED_DEPTH, FAMILY_RUN_DEPTH
        rec_d = len(fam["shipped"]) - 1
        print(f"phase 11d: {m} shipped constants, run_fused to depth {fd} "
              f"and run() to depth {rd}", flush=True)
        _e, fres, finfo = timed(m, "shipped", "run_fused", fd)
        del _e
        _e, rres, rinfo = timed(m, "shipped", "run", rd)
        del _e
        need(fres.levels[:rec_d + 1] == fam["shipped"],
             f"{m} shipped levels {fres.levels[:rec_d + 1]}")
        need(len(fres.levels) == fd + 1 and len(rres.levels) == rd + 1
             and fres.levels[:rd + 1] == rres.levels,
             f"{m} shipped run_fused levels {fres.levels}, run() "
             f"{rres.levels}")
        need(rres.distinct_states == sum(fres.levels[:rd + 1]),
             f"{m} shipped run() distinct {rres.distinct_states}")
        info_m["shipped"] = {"run_fused": finfo, "run": rinfo}
        print(f"  levels {fres.levels} (the JAX record through depth "
              f"{rec_d})", flush=True)

        cd = fam["cover_depth"]
        print(f"phase 11e: {m} shipped constants, recording run() to depth "
              f"{cd}; K13, K14, K3 against their plain versions on the "
              f"calls where each action was enabled most", flush=True)
        rec = ST03Recorder(by_action=True)
        uninstall = rec.install()
        try:
            _e, cres, cinfo = timed(m, "shipped", "run", cd)
        finally:
            uninstall()
        del _e
        need(cres.levels == fres.levels[:cd + 1],
             f"{m} shipped recording run() levels {cres.levels}")
        enabled = check_family_coverage(rec, K, f"{m} shipped")
        del rec
        info_m["cover"] = {"depth": cd, "wall_s": cinfo["wall_s"],
                           "enabled": enabled}
        print(f"  enabled lanes by action: {enabled}", flush=True)
    return rows


class NonceTracker:
    """During a run() of RR05: the largest recovery nonce (``rec_number``
    and the H_X column of present messages) over the successors K14
    enabled, kept on the card and snapshotted at each level's end (no
    host read until ``maxima``)."""

    def install(self, K, eng):
        import torch
        from tpuvsr_torch.models.vsr import H_X
        tr = self
        tr.cur = torch.zeros((), dtype=torch.int32, device=eng.device)
        tr.snaps = []
        orig = K.successors

        def succs(self, flat, pidx, aid, lane, mask, out=None, halt=None):
            o = orig(self, flat, pidx, aid, lane, mask, out, halt)
            if o["en2"].numel():
                st = self.pk.unflatten(o["succ"])
                x = torch.maximum(
                    st["rec_number"].amax(dim=1),
                    torch.where(st["m_present"] == 1,
                                st["m_hdr"][:, :, H_X], 0).amax(dim=1))
                tr.cur = torch.maximum(tr.cur, torch.where(
                    o["en2"], x, 0).amax().to(torch.int32))
            return o
        cal = eng._calibrate_caps

        def level_end(emit, n_front):
            tr.snaps.append(tr.cur.clone())
            return cal(emit, n_front)
        K.successors = succs
        eng._calibrate_caps = level_end

        def uninstall():
            del K.successors
            del eng._calibrate_caps
        return uninstall

    def maxima(self):
        """The largest nonce through depth 1, 2, ... (cumulative)."""
        return [int(x) for x in self.snaps]


def check_range_flag(rec, K, what):
    """K4's range check on the card, on the rows the main path packed: the
    enabled, error-free successors of the K14 queue a recording run kept.
    Packed by the kernel, they leave ``range_flag`` at 0 and equal the
    plain pack.  Then, for each plane with a bounded lane, a copy of one
    row with that plane's last bounded lane set one past its bound, and
    one below it: the kernel sets the flag and the plain version raises
    TLAError naming the plane.  A raw 32-bit lane takes its extreme
    values without the flag and round-trips.  Returns the planes."""
    import numpy as np
    import torch
    from tpuvsr_torch.core.values import TLAError
    kern, flat, pidx, aid, lane, mask, _ok = rec.calls[K.ACTIONS_KERNEL[0]][1]
    o = kern.successors(flat, pidx, aid, lane, mask)
    rows = o["succ"][o["en2"] & (o["err"] == 0)].contiguous()
    need(rows.shape[0] > 0, f"{what}: no enabled successor to pack")
    pk = kern.pk
    flag = pk.range_flag(rows.device)
    need(flag is pk.range_flag("cuda"), f"{what}: the engines' range flag "
         f"(device 'cuda') is not the one the kernel sets ({rows.device})")

    def flagged(x):
        flag.zero_()
        got = pk.pack(x)
        return int(flag.item()), got
    f, got = flagged(rows)
    need(f == 0 and max_abs(got, pk.pack_plain(rows)) == 0,
         f"{what}: K4 on {rows.shape[0]} clean rows: flag {f}, max_abs "
         f"{max_abs(got, pk.pack_plain(rows))}")
    hi = pk._lo.astype(np.int64) + pk._mask.astype(np.int64)
    bounded, raw = [], []
    for key, _shape, a, e in pk._splits:
        lanes = [x for x in range(a, e) if pk._bits[x] < 32]
        if not lanes:
            raw.append((key, a))
            continue
        ln = lanes[-1]
        for v in (int(hi[ln]) + 1, int(pk._lo[ln]) - 1):
            bad = rows[:1].clone()
            bad[0, ln] = v
            f, _w = flagged(bad)
            need(f == 1, f"{what}: K4's range flag stayed 0 with plane "
                 f"{key!r} lane {ln} = {v} (bound [{int(pk._lo[ln])}, "
                 f"{int(hi[ln])}])")
            try:
                pk.pack_plain(bad)
                need(False, f"{what}: the plain pack took {key!r} = {v}")
            except TLAError as err:
                need(repr(key) in str(err), f"{what}: {err}")
        bounded.append(key)
    for key, ln in raw:
        for v in (2 ** 31 - 1, -2 ** 31):
            big = rows[:1].clone()
            big[0, ln] = v
            f, w = flagged(big)
            need(f == 0 and torch.equal(pk.unpack(w), big),
                 f"{what}: raw lane {key!r} = {v}: flag {f}")
    flag.zero_()
    print(f"  K4's range flag: 0 on {rows.shape[0]} packed successors, 1 "
          f"past and below the bound of each of {len(bounded)} planes (the "
          f"plain pack raising on the same rows); raw 32-bit planes "
          f"{[k for k, _l in raw]} take any value", flush=True)
    return {"clean_rows": int(rows.shape[0]), "bounded": bounded,
            "raw": [k for k, _l in raw]}


def jax_manifest_runs(module):
    """Phase 12f: the small cfg of ``module`` (RR05), with no invariant,
    packed under the JAX package's manifest, whose widths pass bounds the
    recovery nonce by 1 + CrashLimit (2 bits): run_fused() to depth 15
    holds; run_fused() and run() to depth 16, where the first nonce of 4
    appears, stop with K4's range error, run() after completing depth
    15.  The JAX package's pack would wrap the nonce to 0 there."""
    import torch
    from tpuvsr_torch.analysis import widths
    from tpuvsr_torch.core.values import TLAError
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    from tpuvsr_torch.engine.spec import load_binding
    out = {}
    saved = widths.NONCE_UNBOUNDED
    widths.NONCE_UNBOUNDED = frozenset()
    try:
        for entry, depth in (("run_fused", 15), ("run_fused", 16),
                             ("run", 16)):
            b = load_binding(family_cfg(module, "small"), module)
            b.invariants = []
            eng = DeviceBFS(b, tile_size=128, chunk_tiles=64,
                            fpset_capacity=1 << 26, device="cuda")
            spec = {k: int(eng._pk._bits[a]) for k, _s, a, _e
                    in eng._pk._splits if k in ("rec_number", "aux_restart")}
            need(spec["rec_number"] == 2, f"the JAX manifest's nonce width "
                 f"{spec}")
            lines, err = [], None
            t0 = time.time()
            try:
                res = getattr(eng, entry)(max_depth=depth, log=lines.append)
            except TLAError as e:
                err = str(e)
            torch.cuda.synchronize()
            wall = time.time() - t0
            done = [int(m.split(":")[0].split()[1]) for m in lines
                    if m.startswith("depth ")]
            what = f"RR05 under the JAX manifest, {entry} to depth {depth}"
            if depth == 15:
                need(err is None and res.ok and len(res.levels) == 16,
                     f"{what}: {err}")
            else:
                need(err is not None and "outside its plane's pack bound"
                     in err, f"{what} did not stop on K4's range flag: "
                     f"{err}")
                if entry == "run":
                    need(done and done[-1] == 15, f"{what}: the last "
                         f"complete level {done[-1:]}")
            print(f"  {what}: {err or 'held'} ({wall:.3f}s)", flush=True)
            out[f"{entry}_{depth}"] = {"error": err, "wall_s": wall,
                                       "widths": spec}
            del eng
    finally:
        widths.NONCE_UNBOUNDED = saved
    return out


def recovery_phase(args, doc):
    """Phase 12: RR05 and AL05, the crash-recovery models, on the card.
    Returns their kernels-line rows, with the launch counts of AL05's
    timed run_fused to its fixpoint (12a) and of RR05's timed run_fused
    to depth RECOVERY_DEPTH (12c)."""
    from tpuvsr_torch.models.registry import _resolve
    rows = []
    out = doc.setdefault("recovery", {})
    al, rr = RECOVERY["AL05"], RECOVERY["RR05"]
    K_al = _resolve(al["module"])[1]
    K_rr = _resolve(rr["module"])[1]

    def trace_of(res):
        return [(t.action_name, repr(t.state)) for t in res.trace]

    def counterexample(m, res, fres, what):
        """run()'s and run_fused()'s first counterexample: the record's
        invariant, depth, actions and levels, the same in both."""
        fam = RECOVERY[m]
        inv, depth, actions = fam["violation"]
        n = depth
        for r, entry in ((res, "run()"), (fres, "run_fused()")):
            need(r.levels == fam["small"][:n] and r.diameter == depth
                 and [a for a, _s in trace_of(r)[1:]] == actions,
                 f"{what} {entry}: levels {r.levels}, diameter "
                 f"{r.diameter}, trace {[a for a, _s in trace_of(r)]}")
        need(trace_of(fres) == trace_of(res),
             f"{what}: run_fused()'s counterexample is not run()'s")
        print(f"  {inv} at depth {depth} in both entry points, levels "
              f"through {depth - 1} the record's", flush=True)

    print("phase 12a: AL05 small cfg with its invariants, recording run() "
          "and run_fused() to the first counterexample; K13, K14, K3 "
          "against their plain versions; with no invariant, run() and "
          "run_fused() to the fixpoint", flush=True)
    viol = al["violation"][0]
    rec = ST03Recorder()
    uninstall = rec.install()
    try:
        _e, res, info = model_run("AL05", al["module"], "small", "run",
                                  violation=viol)
    finally:
        uninstall()
    del _e
    out["AL05_run"] = info
    info["recorded"] = {k: v[0] for k, v in rec.calls.items()}
    al_rows = check_st03_kernels(rec, K_al)
    out["AL05_range"] = check_range_flag(rec, K_al, "AL05")
    del rec
    _e, fres, finfo = model_run("AL05", al["module"], "small", "run_fused",
                                violation=viol)
    del _e
    out["AL05_fused"] = finfo
    counterexample("AL05", res, fres, "AL05")

    def al_fixpoint(res, what):
        need(res.levels == al["small"], f"{what} levels {res.levels}")
        need((res.distinct_states, res.states_generated, res.diameter)
             == al["fixpoint"], f"{what}: {res.distinct_states} distinct,"
             f" {res.states_generated} generated, diameter {res.diameter}")
        need(res.error is None, f"{what}: {res.error}")
    dr = AL05_REACH_RUN_DEPTH
    eng, res, info = model_run("AL05", al["module"], "small", "run", dr,
                               invariants=(), label="AL05 small, no "
                               "invariant,")
    need(res.levels == al["small"][:dr + 1]
         and res.distinct_states == sum(al["small"][:dr + 1]),
         f"AL05 run() with no invariant to depth {dr}: levels "
         f"{res.levels}")
    run_pointers = trace_pointers(eng)
    out["AL05_reach_run"] = info
    del eng
    eng, res, info = model_run("AL05", al["module"], "small", "run_fused",
                               invariants=(), label="AL05 small, no "
                               "invariant,")
    al_fixpoint(res, "AL05 run_fused() with no invariant")
    same_pointers(trace_pointers(eng), run_pointers, res.levels,
                  "AL05 run_fused", args)
    fused_host_reads(res, "AL05")
    del eng, run_pointers
    out["AL05_reach_fused"] = info
    for k in al_rows:
        k["launches"] = info["launches"][k["kernel"]]
    rows += al_rows
    print(f"  levels {res.levels}, pointer tables equal to run()'s "
          f"(to depth {dr})", flush=True)

    print("phase 12b: RR05 small cfg at CrashLimit 0, run() and "
          "run_fused() to its fixpoint (VR_APP_STATE's)", flush=True)
    as04 = FAMILY["AS04"]
    got = {}
    for entry in ("run", "run_fused"):
        eng, res, info = model_run("RR05", rr["module"], "small", entry,
                                   constants={"CrashLimit": 0},
                                   label="RR05 small CrashLimit 0")
        need(res.levels == as04["small"] and res.error is None
             and (res.distinct_states, res.states_generated,
                  res.diameter) == as04["fixpoint"],
             f"RR05 CrashLimit 0 {entry}: {res.levels} "
             f"{res.distinct_states} {res.states_generated} "
             f"{res.diameter} {res.error}")
        got[entry] = trace_pointers(eng)
        out[f"RR05_crash0_{entry}"] = info
        del eng
    same_pointers(got["run_fused"], got["run"], as04["small"],
                  "RR05 CrashLimit 0 run_fused", args)
    del got
    print(f"  levels {as04['small']}, {as04['fixpoint']}", flush=True)

    d, viol = RECOVERY_DEPTH, rr["violation"]
    print(f"phase 12c: RR05 small cfg (CrashLimit 1), recording run() and "
          f"run_fused() to depth {d}; both stop on {viol[0]} at depth "
          f"{viol[1]}", flush=True)
    rec, tracker, lines = ST03Recorder(), NonceTracker(), []
    uninstall = rec.install()
    try:
        eng, res, info = model_run(
            "RR05", rr["module"], "small", "run", d, log=lines.append,
            setup=lambda e: tracker.install(K_rr, e), violation=viol[0])
    finally:
        uninstall()
    del eng
    maxima = tracker.maxima()
    cum = {}
    for msg in lines:
        if msg.startswith("depth ") and ", generated " in msg:
            dd = int(msg.split(":")[0].split()[1])
            cum[dd] = (int(msg.split("distinct ")[1].split(",")[0]),
                       int(msg.split("generated ")[1]))
    n_rec = len(rr["small"]) - 1
    need([cum[x][1] for x in range(1, n_rec + 1)] == rr["generated"][1:],
         f"RR05 recording run() generated {cum}")
    first4 = next((i + 1 for i, x in enumerate(maxima) if x >= 4), None)
    need(first4 == rr["nonce4_depth"], f"RR05 first nonce of 4 at depth "
         f"{first4} (maxima {maxima})")
    for dd, want in rr["log"].items():
        need(dd < first4 and cum[dd] == want,
             f"RR05 depth {dd}: {cum.get(dd)} against the log's {want}")
    info["recorded"] = {k: v[0] for k, v in rec.calls.items()}
    info["nonce_maxima"] = maxima
    info["cumulative"] = cum
    out["RR05_run"] = info
    print(f"  levels {res.levels}; the JAX record through depth {n_rec}, "
          f"the log at depths {sorted(rr['log'])}; the largest nonce by "
          f"depth {maxima}; {viol[0]} at depth {res.diameter}", flush=True)
    rr_rows = check_st03_kernels(rec, K_rr)
    out["RR05_range"] = check_range_flag(rec, K_rr, "RR05")
    del rec
    eng, fres, finfo = model_run("RR05", rr["module"], "small", "run_fused",
                                 d, violation=viol[0])
    counterexample("RR05", res, fres, "RR05")
    fused_host_reads(fres, "RR05")
    del eng
    out["RR05_fused"] = finfo
    for k in rr_rows:
        k["launches"] = finfo["launches"][k["kernel"]]
    rows += rr_rows

    D = RECOVERY_DEEP
    print(f"  with no invariant: run() to depth {D['run']} (the largest "
          f"nonce tracked) and run_fused() to depth {D['fused']}",
          flush=True)
    tracker = NonceTracker()
    eng, rres, rinfo = model_run(
        "RR05", rr["module"], "small", "run", D["run"], invariants=(),
        setup=lambda e: tracker.install(K_rr, e),
        label="RR05 small, no invariant,")
    run_pointers = trace_pointers(eng)
    del eng
    eng, fres, finfo = model_run(
        "RR05", rr["module"], "small", "run_fused", D["fused"],
        invariants=(), label="RR05 small, no invariant,")
    same_pointers(trace_pointers(eng), run_pointers, fres.levels,
                  "RR05 no-invariant run_fused", args)
    fused_host_reads(fres, "RR05 with no invariant")
    del eng, run_pointers
    n = len(rr["small"])
    need(len(fres.levels) == D["fused"] + 1
         and len(rres.levels) == D["run"] + 1
         and fres.levels[:D["run"] + 1] == rres.levels
         and rres.levels[:n] == rr["small"],
         f"RR05 with no invariant: run_fused levels {fres.levels}, run() "
         f"{rres.levels}")
    maxima = tracker.maxima()
    first4 = next((i + 1 for i, x in enumerate(maxima) if x >= 4), None)
    need(first4 == rr["nonce4_depth"] and maxima[-1] > 4,
         f"RR05 with no invariant: the largest nonce by depth {maxima}")
    rinfo["nonce_maxima"] = maxima
    out["RR05_deep"] = {"run": rinfo, "run_fused": finfo}
    print(f"  levels {fres.levels}, run()'s through depth {D['run']} with "
          f"equal pointer tables; the largest nonce by depth {maxima}",
          flush=True)

    W = RECOVERY_WIDE
    for m, K in (("RR05", K_rr), ("AL05", K_al)):
        fam = RECOVERY[m]
        print(f"phase 12d: {m} wide cfg, run_fused to depth {W['fused']} "
              f"and run() to depth {W['run']}", flush=True)
        _e, fres, finfo = model_run(m, fam["module"], "wide", "run_fused",
                                    W["fused"])
        del _e
        _e, rres, rinfo = model_run(m, fam["module"], "wide", "run",
                                    W["run"])
        del _e
        n = len(fam["wide"])
        need(fres.levels[:n] == fam["wide"]
             and len(fres.levels) == W["fused"] + 1
             and rres.levels == fres.levels[:W["run"] + 1],
             f"{m} wide run_fused levels {fres.levels}, run() "
             f"{rres.levels}")
        out[f"{m}_wide"] = {"run_fused": finfo, "run": rinfo}
        print(f"  levels {fres.levels} (the JAX record through depth "
              f"{n - 1})", flush=True)

        print(f"phase 12e: {m} wide cfg, recording run() to depth "
              f"{W['cover']}; K13, K14, K3 against their plain versions on "
              f"the calls where each action was enabled most", flush=True)
        rec = ST03Recorder(by_action=True)
        uninstall = rec.install()
        try:
            _e, cres, cinfo = model_run(m, fam["module"], "wide", "run",
                                        W["cover"])
        finally:
            uninstall()
        del _e
        need(cres.levels == fres.levels[:W["cover"] + 1],
             f"{m} wide recording run() levels {cres.levels}")
        enabled = check_family_coverage(rec, K, f"{m} wide")
        del rec
        out[f"{m}_cover"] = {"depth": W["cover"], "wall_s": cinfo["wall_s"],
                             "enabled": enabled}
        print(f"  enabled lanes by action: {enabled}", flush=True)

    print("phase 12f: RR05 small cfg packed under the JAX package's "
          "manifest (the nonce in 2 bits), with no invariant: K4's range "
          "flag stops both entry points at depth 16", flush=True)
    out["RR05_jax_manifest"] = jax_manifest_runs(rr["module"])
    return rows


def check_checkpoint_rows(module):
    """Phase 13d: on the rows of ``testing.checkpoint_rows`` in the small
    and the wide layout (MAX_MSGS 16), on the card, K13 over every lane,
    K14 over every (row, lane) item under the cfg's invariants and under
    each invariant alone, and K3 (parts, incremental, full) bit for bit
    against their plain versions.  Returns, a layout, each action's
    enabled lanes and, for ReceiveGetState and ReceiveRecoveryMsg, the
    enabled checkpoint (cp > 0, flag 1) and suffix (cp = 0) lanes."""
    import numpy as np
    import torch
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.models.registry import make_model
    from tpuvsr_torch.testing import checkpoint_rows
    out = {}
    for size in ("small", "wide"):
        what = f"CP06 {size} built rows"
        b = load_binding(family_cfg(module, size), module)
        codec, kern = make_model(b, max_msgs=16)
        rows = checkpoint_rows(codec)
        flat = kern.pk.flatten({k: torch.as_tensor(np.stack(
            [r[k] for r in rows])) for k in rows[0]}).contiguous().cuda()
        dev, B, L = flat.device, flat.shape[0], kern.n_lanes
        g, gp = kern.guard_matrix(flat), kern.guard_matrix_plain(flat)
        need(max(max_abs(g[0], gp[0]), max_abs(g[1], gp[1])) == 0,
             f"{what}: {kern.GUARDS_KERNEL[0]} differs from its plain "
             f"version")
        pidx = torch.arange(B, dtype=torch.int32,
                            device=dev).repeat_interleave(L)
        aid = torch.as_tensor(kern.lane_action, device=dev).repeat(B)
        lane = torch.as_tensor(kern.lane_param, device=dev).repeat(B)
        cfg_mask = kern.invariant_mask(b.invariants)
        for m in [cfg_mask] + [1 << x for x in range(len(
                kern.INVARIANT_FNS))]:
            a = kern.successors(flat, pidx, aid, lane, m)
            p = kern.successors_plain(flat, pidx, aid, lane, m)
            bad = [k for k in a if max_abs(a[k], p[k]) != 0]
            need(not bad, f"{what}: {kern.ACTIONS_KERNEL[0]} differs "
                 f"from its plain version in {bad} (invariant mask {m})")
        parts, pparts = kern.parent_parts(flat), kern.parent_parts_plain(flat)
        need(all(max_abs(x, y) == 0 for x, y in zip(parts, pparts))
             and max_abs(kern.fingerprint(a["succ"]),
                         kern.fingerprint_plain(a["succ"])) == 0
             and max_abs(kern.fingerprint_incremental(
                 a["succ"], a["ri"], a["ts"], pidx, flat, parts),
                 kern.fingerprint_incremental_plain(
                     a["succ"], a["ri"], a["ts"], pidx, flat, pparts)) == 0,
             f"{what}: K3 differs from its plain version")
        en = g[0].cpu().numpy()
        per = {n: int(en[:, kern.lane_action == x].sum())
               for x, n in enumerate(kern.action_names)}
        cp = kern.lane_param % (kern.MAX_OPS + 1)
        lanes = {n: {"checkpoint": int(en[:, (kern.lane_action == x)
                                             & (cp > 0)].sum()),
                     "suffix": int(en[:, (kern.lane_action == x)
                                         & (cp == 0)].sum())}
                 for x, n in enumerate(kern.action_names)
                 if n in ("ReceiveGetState", "ReceiveRecoveryMsg")}
        out[size] = {"enabled": per, "reply_lanes": lanes,
                     "items": int(pidx.shape[0])}
    torch.cuda.synchronize()
    return out


def checkpoint_phase(args, doc):
    """Phase 13: CP06 (VR_REPLICA_RECOVERY_CP), the checkpointing model,
    on its own instantiations of K13, K14 and K3.  Returns its
    kernels-line rows, with the launch counts of the timed run_fused to
    the small cfg's fixpoint (13a)."""
    from tpuvsr_torch.models.registry import _resolve
    cp, W = CHECKPOINT, CHECKPOINT_WIDE
    K = _resolve(cp["module"])[1]
    out = doc.setdefault("checkpoint", {})

    def fixpoint(res, what):
        need(res.levels == cp["small"], f"{what} levels {res.levels}")
        need((res.distinct_states, res.states_generated, res.diameter)
             == cp["fixpoint"], f"{what}: {res.distinct_states} distinct, "
             f"{res.states_generated} generated, diameter {res.diameter}")
        need(res.ok and res.error is None, f"{what}: "
             f"{res.violated_invariant} {res.error}")

    print("phase 13a: CP06 small cfg, recording run() to its fixpoint; "
          "K13, K14, K3 against their plain versions; K4's range check; "
          "run_fused() to the fixpoint", flush=True)
    rec, tracker, lines = ST03Recorder(by_action=True), NonceTracker(), []
    uninstall = rec.install()
    try:
        eng, res, info = model_run(
            "CP06", cp["module"], "small", "run", log=lines.append,
            setup=lambda e: tracker.install(K, e))
    finally:
        uninstall()
    crash = eng.kern.crash_limit
    run_pointers = trace_pointers(eng)
    del eng
    fixpoint(res, "CP06 recording run()")
    gen = [1] + [int(m.split("generated ")[1]) for m in lines
                 if m.startswith("depth ") and ", generated " in m]
    need(gen[:len(cp["generated"])] == cp["generated"],
         f"CP06 recording run() cumulative generated {gen}")
    maxima = tracker.maxima()
    need(max(maxima) == cp["nonce"] <= 1 + crash, f"CP06 the largest "
         f"nonce by depth {maxima} (bound {1 + crash})")
    info["recorded"] = {k: v[0] for k, v in rec.calls.items()
                        if isinstance(k, str)}
    info["nonce_maxima"] = maxima
    out["record"] = info
    print(f"  levels, totals and cumulative generated counts the record's; "
          f"the largest nonce {max(maxima)} (bound 1 + CrashLimit = "
          f"{1 + crash})", flush=True)
    rows = check_st03_kernels(rec, K)
    out["range"] = check_range_flag(rec, K, "CP06")
    # one value: no state transfer (a Prepare two ops ahead needs two)
    small_on = check_family_coverage(
        rec, K, "CP06 small", idle=("SendGetState", "ReceiveGetState",
                                    "ReceiveNewState", "NoProgressChange"))
    out["cover_small"] = small_on
    print(f"  enabled lanes by action on the fixpoint: {small_on}",
          flush=True)
    del rec
    eng, fres, finfo = model_run("CP06", cp["module"], "small", "run_fused")
    fixpoint(fres, "CP06 run_fused()")
    same_pointers(trace_pointers(eng), run_pointers, fres.levels,
                  "CP06 run_fused", args)
    fused_host_reads(fres, "CP06")
    del eng, run_pointers
    out["fused"] = finfo
    for k in rows:
        k["launches"] = finfo["launches"][k["kernel"]]
    print(f"  run_fused(): the record's fixpoint, pointer tables equal to "
          f"run()'s", flush=True)

    print(f"phase 13b: CP06 wide cfg, run_fused to depth {W['fused']} and "
          f"run() to depth {W['run']}", flush=True)
    _e, fres, finfo = model_run("CP06", cp["module"], "wide", "run_fused",
                                W["fused"])
    del _e
    _e, rres, rinfo = model_run("CP06", cp["module"], "wide", "run",
                                W["run"])
    del _e
    n = len(cp["wide"])
    need(fres.levels[:n] == cp["wide"] and len(fres.levels) == W["fused"] + 1
         and rres.levels == fres.levels[:W["run"] + 1],
         f"CP06 wide run_fused levels {fres.levels}, run() {rres.levels}")
    out["wide"] = {"run_fused": finfo, "run": rinfo}
    print(f"  levels {fres.levels} (the JAX host BFS's through depth "
          f"{n - 1})", flush=True)

    print(f"phase 13c: CP06 wide cfg, recording run() to depth "
          f"{W['cover']}; K13, K14, K3 against their plain versions on the "
          f"calls where each action was enabled most", flush=True)
    rec = ST03Recorder(by_action=True)
    uninstall = rec.install()
    try:
        _e, cres, cinfo = model_run("CP06", cp["module"], "wide", "run",
                                    W["cover"])
    finally:
        uninstall()
    del _e
    need(cres.levels == fres.levels[:W["cover"] + 1],
         f"CP06 wide recording run() levels {cres.levels}")
    # by depth 12 no view change completes (SendSV needs two DoViewChanges,
    # and a replica sends one only once it has committed) and state
    # transfer cannot open; 13d holds those actions
    late = ("SendSV", "ReceiveSV", "SendGetState", "ReceiveGetState",
            "ReceiveNewState")
    enabled = check_family_coverage(rec, K, "CP06 wide",
                                    idle=late + ("NoProgressChange",))
    del rec
    out["cover"] = {"depth": W["cover"], "wall_s": cinfo["wall_s"],
                    "enabled": enabled}
    print(f"  enabled lanes by action: {enabled}", flush=True)

    print("phase 13d: CP06's hand-built rows (testing.checkpoint_rows), "
          "small and wide layouts: K13, K14, K3 against their plain "
          "versions on every lane", flush=True)
    built = check_checkpoint_rows(cp["module"])
    out["built"] = built
    wide = built["wide"]
    need(all(wide["enabled"][a] > 0 for a in late),
         f"CP06 wide built rows enable {wide['enabled']}")
    need(all(min(v.values()) > 0 for v in wide["reply_lanes"].values()),
         f"CP06 wide built rows: reply lanes {wide['reply_lanes']}")
    for n in (K.GUARDS_KERNEL[0], K.ACTIONS_KERNEL[0]):
        never = [a for a in K.action_names if a != "NoProgressChange"
                 and not (small_on[n][a] or enabled[n][a]
                          or built["small"]["enabled"][a]
                          or wide["enabled"][a])]
        need(not never, f"CP06: {never} held on no input of {n}")
    print(f"  every action but NoProgressChange held; on the built rows "
          f"{ {s: v['enabled'] for s, v in built.items()} }, reply lanes "
          f"(checkpoint, suffix) {wide['reply_lanes']}", flush=True)
    return rows


def check_family_canon(rec, K, m, cfg):
    """Phase 14a: model ``m``'s K9 bit for bit against its plain version
    on the largest call of the recording run, its images invariant under
    every group row; timed with its bound (each row read once and written
    once)."""
    import torch
    from tpuvsr_torch.engine.canon import MODES
    out = []
    name = K.CANON_KERNEL
    canon, rows = rec.calls[name][1]
    pk = canon.kern.pk
    n, L = rows.shape
    got = canon.canonicalize(rows)
    err = max_abs(got, canon.canonicalize_plain(rows))
    for g in canon.tables(rows.device)["group"]:
        moved = pk.flatten(canon.kern._permuted(pk.unflatten(rows), g))
        need(torch.equal(canon.canonicalize(moved), got),
             f"{name}: K9's images are not invariant under the group")
    mode = MODES[canon.mode]
    dst = torch.empty_like(rows)
    kernel_row(out, name, cuda_ms(lambda: canon.canonicalize(rows, dst)),
               cuda_ms(lambda: canon.canonicalize_plain(rows), reps=5), err,
               2 * n * L * 4, 0,
               extra={"shape": [n, L], "perms": canon.perms, "mode": mode,
                      "shift": canon.shift, "model": m,
                      "key_lanes": int(canon.pos.shape[0])},
               label=f"{name} (K9, {mode} mode, {m} {cfg})")
    torch.cuda.synchronize()
    return out


def unsymmetric_fused(doc, m):
    """(depth, cumulative distinct) of model ``m``'s unsymmetric
    run_fused on the same constants in phase 10d, 11d, 12d or 13b."""
    if m == "ST03":
        return (ST03_SHIPPED_DEPTH,
                doc["st03_shipped"]["run_fused"]["distinct"])
    if m in FAMILY:
        return (FAMILY_FUSED_DEPTH,
                doc["family"][m]["shipped"]["run_fused"]["distinct"])
    if m in RECOVERY:
        return (RECOVERY_WIDE["fused"],
                doc["recovery"][f"{m}_wide"]["run_fused"]["distinct"])
    return (CHECKPOINT_WIDE["fused"],
            doc["checkpoint"]["wide"]["run_fused"]["distinct"])


def family_symmetry_phase(args, doc):
    """Phase 14: the family with symmetry on.  Returns K9's kernels-line
    rows, one a model, with the launch counts of its deeper run_fused
    (14b)."""
    from tpuvsr_torch.engine.paged_bfs import PagedBFS
    from tpuvsr_torch.models.registry import _resolve
    with open(FAMILY_SYMMETRY_RECORD) as f:
        record = json.load(f)
    out = doc.setdefault("family_symmetry", {})
    rows = []
    t_phase = time.time()
    paged_m, paged_d = SYMMETRY_PAGED
    for m, (module, size) in FAMILY_SYMMETRY.items():
        K = _resolve(module)[1]
        cfg = f"{size}_symmetry"
        D = SYMMETRY_DEPTHS[size]
        want = record[m]
        rd = want["depth"]
        info_m = out.setdefault(m, {"record_depth": rd})

        def held(res, what):
            """The run's levels through the record's depth the record's,
            and its generated count where its depth is within it."""
            d = len(res.levels) - 1
            n = min(d, rd) + 1
            need(res.levels[:n] == want["levels"][:n],
                 f"{m} {what} levels {res.levels[:n]}, the record "
                 f"{want['levels'][:n]}")
            if d <= rd:
                need(res.states_generated == want["generated"][d],
                     f"{m} {what} generated {res.states_generated}, the "
                     f"record {want['generated'][d]}")

        d = SYMMETRY_RECORD_DEPTH
        print(f"phase 14a: {m} {cfg} cfg, recording run() to depth {d}; "
              f"K9 ({K.CANON_MODE[0]} mode) against its plain version",
              flush=True)
        rec = CanonRecorder()
        uninstall = rec.install()
        try:
            e, res, info = model_run(m, module, cfg, "run", d)
        finally:
            uninstall()
        del e
        held(res, "recording run()")
        need(rec.relabelled > 0,
             f"{m}: K9 relabelled no row in the recording run")
        info_m["record"] = {"wall_s": info["wall_s"],
                            "canon_rows": rec.rows,
                            "canon_relabelled": rec.relabelled}
        print(f"  K9 relabelled {rec.relabelled} of {rec.rows} rows",
              flush=True)
        mrows = check_family_canon(rec, K, m, cfg)
        del rec

        print(f"phase 14b: {m} {cfg} cfg, run_fused() to depth "
              f"{D['fused']}, run_fused() and run() to depth {D['run']}",
              flush=True)
        e, fres, finfo = model_run(m, module, cfg, "run_fused", D["fused"])
        fused_ptr = trace_pointers(e)
        del e
        e, sres, sinfo = model_run(m, module, cfg, "run_fused", D["run"])
        short_ptr = trace_pointers(e)
        del e
        e, rres, rinfo = model_run(m, module, cfg, "run", D["run"])
        run_ptr = trace_pointers(e)
        del e
        fused_host_reads(fres, m)
        fused_host_reads(sres, m)
        for what, r in (("run_fused()", fres), ("run_fused()", sres),
                        ("run()", rres)):
            held(r, what)
        need(len(fres.levels) == D["fused"] + 1
             and len(rres.levels) == D["run"] + 1
             and rres.levels == fres.levels[:D["run"] + 1]
             and sres.levels == rres.levels,
             f"{m} symmetric run_fused levels {fres.levels}, run() "
             f"{rres.levels}")
        need((rres.distinct_states, rres.states_generated)
             == (sres.distinct_states, sres.states_generated),
             f"{m} symmetric run() {rres.distinct_states} / "
             f"{rres.states_generated}, run_fused() {sres.distinct_states}"
             f" / {sres.states_generated} at depth {D['run']}")
        same_pointers(short_ptr, run_ptr, rres.levels,
                      f"{m} symmetric run_fused", args)
        n_run = sum(rres.levels)
        same_pointers([a[:n_run] for a in fused_ptr], run_ptr, rres.levels,
                      f"{m} symmetric deeper run_fused", args)
        info_m.update({"run_fused": finfo, "run_fused_short": sinfo,
                       "run": rinfo})
        print(f"  levels {fres.levels} (the JAX record through depth "
              f"{min(rd, D['fused'])}); run()'s levels, counts and pointer "
              f"tables run_fused()'s", flush=True)
        for k in mrows:
            k["launches"] = finfo["launches"][k["kernel"]]
        rows += mrows

        depth, off = unsymmetric_fused(doc, m)
        need(depth == D["fused"], f"{m}: the unsymmetric run went to "
             f"{depth}, the symmetric one to {D['fused']}")
        on = fres.distinct_states
        print(f"phase 14c: {m} at depth {depth}: {on} orbits, {off} states "
              f"(ceil(off / 2) = {-(-off // 2)})", flush=True)
        need(-(-off // 2) <= on <= off, f"{m} at depth {depth}: {on} "
             f"orbits against {off} states")
        info_m["orbits_vs_states"] = {"depth": depth, "on": on, "off": off}

        if m == paged_m:
            print(f"phase 14d: PagedBFS, {m} {cfg} cfg to depth {paged_d}",
                  flush=True)
            need(paged_d == D["run"], "14d's depth is not 14b's run()'s")
            e, pres, pinfo = model_run(
                m, module, cfg, "run", paged_d,
                label=f"{m} {cfg} PagedBFS", engine_cls=PagedBFS,
                next_capacity=PAGED["next_capacity"])
            need(pres.levels == rres.levels
                 and (pres.distinct_states, pres.states_generated)
                 == (rres.distinct_states, rres.states_generated),
                 f"{m} symmetric PagedBFS levels {pres.levels}, "
                 f"{pres.distinct_states} / {pres.states_generated}")
            same_pointers(trace_pointers(e), run_ptr, rres.levels,
                          f"{m} symmetric PagedBFS", args)
            del e
            out["paged"] = pinfo
            print(f"  levels {pres.levels}, counts and pointer tables "
                  f"run()'s; drains {pres.metrics['counters'].get('drains')}",
                  flush=True)
    out["wall_s"] = time.time() - t_phase
    print(f"  phase 14: {out['wall_s']:.1f} s", flush=True)
    return rows


class PaRecorder:
    """Keeps the inputs of the K15 calls of an eager per-action run
    (cloned before each call, which steps the carry): the gate with the
    most enabled items, the finish with the most fresh items, and the
    finish of a tile's last action (the verdict's fold) with the most."""

    def __init__(self):
        self.calls = {}

    def keep(self, name, size, snap):
        if size > self.calls.get(name, (-1, None))[0]:
            self.calls[name] = (size, snap)

    def install(self):
        from tpuvsr_torch.engine import device_bfs as D
        gate, finish = D.action_gate, D.action_finish
        rec = self

        def action_gate(carry, pa, q, o, a, total_e, mcommit):
            snap = (carry.clone(), pa.clone(),
                    {k: v.clone() for k, v in q.items()},
                    {k: o[k].clone() for k in ("en2", "iok", "err")},
                    a, total_e)
            out = gate(carry, pa, q, o, a, total_e, mcommit)
            rec.keep("action_gate", int((o["en2"] & q["ok"]).sum()), snap)
            return out

        def action_finish(carry, pa, q, fresh, ovf_i, a, cnts, en_any,
                          valid, bufs, dest):
            snap = (carry.clone(), pa.clone(),
                    {k: q[k].clone() for k in ("pidx", "lane", "aid")},
                    fresh.clone(), ovf_i.clone(), a, cnts.clone(),
                    en_any.clone(), valid.clone(), bufs.cap)
            out = finish(carry, pa, q, fresh, ovf_i, a, cnts, en_any,
                         valid, bufs, dest)
            n = int(fresh.sum())
            rec.keep("action_finish", n, snap)
            if a == cnts.shape[0] - 1:
                rec.keep("action_finish_last", n, snap)
            return out

        D.action_gate, D.action_finish = action_gate, action_finish

        def uninstall():
            D.action_gate, D.action_finish = gate, finish
        return uninstall


def check_k15(rec):
    """Phase 15f: K15's two entries against their plain versions on the
    recorded calls, bit for bit (the carry, the chain, the masks, the
    rows and the pointer columns), each timed (carry and chain restored
    before every call) with its bound."""
    import torch
    from tpuvsr_torch.engine import tile as TL
    from tpuvsr_torch.engine.device_bfs import _Bufs
    out = []
    carry, pa, q, o, a, total_e = rec.calls["action_gate"][1]
    dev = carry.device
    E = o["en2"].shape[0]
    ca, cb, pa_a, pa_b = carry.clone(), carry.clone(), pa.clone(), pa.clone()
    ma, mb = (torch.zeros((E,), dtype=torch.bool, device=dev)
              for _ in range(2))
    TL.action_gate(ca, pa_a, q, o, a, total_e, ma)
    TL.action_gate_plain(cb, pa_b, q, o, a, total_e, mb)
    err = max(max_abs(ca, cb), max_abs(pa_a, pa_b), max_abs(ma, mb))
    n_ok = int((o["en2"] & q["ok"]).sum())
    kernel_row(out, "action_gate",
               cuda_ms(lambda: TL.action_gate(ca, pa_a, q, o, a, total_e,
                                              ma),
                       pre=lambda: pa_a.copy_(pa)),
               cuda_ms(lambda: TL.action_gate_plain(cb, pa_b, q, o, a,
                                                    total_e, mb),
                       reps=5, pre=lambda: pa_b.copy_(pa)),
               err, 8 * E + 2 * 8 * pa.numel() + 32, 6 * E,
               extra={"shape": [E], "action": a, "enabled": n_ok,
                      "mcommit": int(ma.sum())})
    for key in ("action_finish", "action_finish_last"):
        (carry, pa, q, fresh, ovf_i, a, cnts, en_any, valid,
         cap) = rec.calls[key][1]
        E, T, n_act = fresh.shape[0], valid.shape[0], cnts.shape[0]
        ca, cb = carry.clone(), carry.clone()
        pa_a, pa_b = pa.clone(), pa.clone()
        ba, bb = _Bufs(cap, 1, dev), _Bufs(cap, 1, dev)
        da, db = (torch.zeros((E,), dtype=torch.int32, device=dev)
                  for _ in range(2))
        args_a = (q, fresh, ovf_i, a, cnts, en_any, valid, ba, da)
        args_b = (q, fresh, ovf_i, a, cnts, en_any, valid, bb, db)
        TL.action_finish(ca, pa_a, *args_a)
        TL.action_finish_plain(cb, pa_b, *args_b)
        err = max(max_abs(ca, cb), max_abs(pa_a, pa_b), max_abs(da, db),
                  *(max_abs(getattr(ba, k), getattr(bb, k))
                    for k in ("par", "act", "prm")))
        need(err == 0, f"{key}: K15 differs from its plain version")
        n_fresh = int(fresh.sum())
        last = a == n_act - 1
        if key == "action_finish_last":
            print(f"  action_finish of the last action ({n_fresh} fresh, "
                  f"reason {int(ca[TL.C_REASON])}): equal to its plain "
                  f"version", flush=True)
            continue

        def restore(c, p_, saved=(carry, pa)):
            return lambda: (c.copy_(saved[0]), p_.copy_(saved[1]))
        kernel_row(out, "action_finish",
                   cuda_ms(lambda: TL.action_finish(ca, pa_a, *args_a),
                           pre=restore(ca, pa_a)),
                   cuda_ms(lambda: TL.action_finish_plain(cb, pa_b,
                                                          *args_b),
                           reps=5, pre=restore(cb, pa_b)),
                   err, 13 * E + 12 * n_fresh
                   + (2 * T + 8 * n_act if last else 0)
                   + 2 * 8 * (carry.numel() + pa.numel()), 2 * E,
                   extra={"shape": [E], "action": a, "fresh": n_fresh})
    torch.cuda.synchronize()
    return out


def pa_counts_ok(counts, what):
    """The per-action commit's kernels launched on a path, the fused
    commit's K8 entries not."""
    for k in ("action_gate", "action_finish", "compact", "dedup_batch",
              "fpset_insert", "pack"):
        need(counts[k] > 0, f"{k} was not launched on {what}")
    for k in ("commit_prefix", "commit_finish"):
        need(counts[k] == 0, f"{k} was launched on {what}")


def per_action_phase(args, doc):
    """Phase 15: the per-action commit through run(), run_fused() and
    PagedBFS.  Returns K15's kernels-line rows, with the launch counts of
    15a's run_fused."""
    import hashlib
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    from tpuvsr_torch.engine.paged_bfs import PagedBFS
    from tpuvsr_torch.engine.spec import load_binding
    P = PER_ACTION
    t_phase = time.time()
    out = doc["per_action"] = {}
    binding = load_binding(DEFECT, "VSR")
    depth = args.depth
    levels = LEVELS[:depth + 1]
    record = json.load(open(PER_ACTION_RECORD))

    def engine(cls=DeviceBFS, **kw):
        return cls(binding, tile_size=128, chunk_tiles=64,
                   fpset_capacity=1 << 26, device="cuda",
                   commit="per-action", **kw)

    def digest(tables, n):
        h = hashlib.sha256()
        for t, dt in zip(tables, (np.int64, np.int32, np.int32)):
            h.update(np.ascontiguousarray(t[:n].astype(dt)).tobytes())
        return h.hexdigest()

    print(f"phase 15a: the per-action commit, defect config: an untimed "
          f"recording run() to depth {P['record_depth']}, then run() and "
          f"run_fused() to depth {depth}", flush=True)
    rec = PaRecorder()
    uninstall = rec.install()
    try:
        eng = engine()
        r = eng.run(max_depth=P["record_depth"])
    finally:
        uninstall()
    need(r.levels == LEVELS[:P["record_depth"] + 1],
         f"per-action recording levels {r.levels}")
    del eng
    ref = {"run": doc["main"], "run_fused": doc["fused"]}
    n_rec = sum(record["levels"])
    tables = {}
    for entry in ("run", "run_fused"):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        plain0 = plain_calls()
        eng = engine()
        t0 = time.time()
        res = getattr(eng, entry)(max_depth=depth)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        what = f"per-action {entry}"
        k10_only(counts, plain0, what)
        pa_counts_ok(counts, what)
        if entry == "run_fused":
            need(counts["level_step"] > 0, f"level_step not launched on "
                 f"{what}")
        want = ref[entry]
        need(res.ok and res.levels == levels
             and res.distinct_states == want["distinct"]
             and res.states_generated == want["generated"],
             f"{what}: levels {res.levels}, distinct "
             f"{res.distinct_states}, generated {res.states_generated}")
        acts = res.metrics["gauges"]["action_expansions"]
        need(acts == want["metrics"]["gauges"]["action_expansions"],
             f"{what}: per-action counters {acts}")
        g = res.metrics["gauges"]
        need((g["commit_mode"], g["inserts_per_tile"]) == (
            "per-action", len(eng.kern.action_names)),
             f"{what}: gauges {g['commit_mode']} {g['inserts_per_tile']}")
        tables[entry] = trace_pointers(eng)
        dg = digest(tables[entry], n_rec)
        need(dg == record["per-action"]["digest"],
             f"{what}: trace-pointer tables through level "
             f"{record['depth']} have digest {dg}, the JAX per-action "
             f"record {record['per-action']['digest']}")
        c = res.metrics["counters"]
        if entry == "run_fused":
            fused_host_reads(res, what)
            out["launches"] = counts
        else:
            # at most one a tile: a tile the host's headroom gate stops
            # runs nothing on the card and is read from no one
            need(0 < c["tile_reads"] <= c["tiles"],
                 f"{what}: {c['tile_reads']} host reads of a tile's "
                 f"results for {c['tiles']} tiles")
        out[entry] = {"levels": res.levels, "wall_s": wall,
                      "distinct_per_s": res.distinct_states / wall,
                      "counters": c, "gauges": g}
        print(f"  {what}: levels, counts and per-action counters those of "
              f"phase {'5' if entry == 'run' else '7c'}; pointer tables "
              f"through level {record['depth']} the JAX per-action "
              f"record's; wall {wall:.3f}s against the fused commit's "
              f"{want['wall_s']:.3f}s; host_reads "
              f"{c.get('host_reads', c.get('tile_reads'))} graph_captures "
              f"{c.get('graph_captures')} tiles {c.get('tiles')}",
              flush=True)
        del eng
    same_pointers(tables["run_fused"], tables["run"], levels,
                  "per-action run_fused", args)
    diff = [int((a != b).sum()) for a, b in
            zip(tables["run"], doc["main_pointers"])]
    out["rows_unlike_fused"] = diff
    print(f"  per-action run_fused()'s pointer tables run()'s; they differ "
          f"from the fused commit's in {diff} entries (parent, action, "
          f"lane), where an action's batch holds equal successors",
          flush=True)
    del tables

    print(f"phase 15b: shipped VSR, symmetry on, run_fused() to depth "
          f"{P['shipped_depth']}, per-action and fused", flush=True)
    sb = load_binding(SHIPPED, "VSR")
    runs = {}
    for commit in ("per-action", "fused"):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        eng = DeviceBFS(sb, tile_size=128, chunk_tiles=64,
                        fpset_capacity=1 << 26, device="cuda",
                        commit=commit)
        t0 = time.time()
        res = eng.run_fused(max_depth=P["shipped_depth"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        need(counts["vsr_canon"] > 0 and counts["vsr_fp_full"] > 0
             and counts["vsr_fp_incremental"] == 0,
             f"shipped {commit}: K9/K3 launches {counts}")
        if commit == "per-action":
            pa_counts_ok(counts, "shipped per-action run_fused")
        runs[commit] = (res, wall)
        del eng
    (pr, pw), (fr, fw) = runs["per-action"], runs["fused"]
    need(pr.levels == fr.levels == SHIPPED_LEVELS[:P["shipped_depth"] + 1]
         and (pr.distinct_states, pr.states_generated)
         == (fr.distinct_states, fr.states_generated)
         and pr.metrics["gauges"]["action_expansions"]
         == fr.metrics["gauges"]["action_expansions"],
         f"shipped per-action: levels {pr.levels}, the fused run's "
         f"{fr.levels}")
    out["shipped"] = {"levels": pr.levels, "wall_s": pw, "fused_wall_s": fw}
    print(f"  levels those of the fused run and the record, generated "
          f"{pr.states_generated}; wall {pw:.3f}s per-action, {fw:.3f}s "
          f"fused", flush=True)

    print("phase 15c: ST03 small cfg to its fixpoint through run_fused(), "
          "per-action", flush=True)
    eng, res, info = model_run("ST03", "VR_STATE_TRANSFER", "small",
                               "run_fused", commit="per-action",
                               label="ST03 small per-action")
    need((res.distinct_states, res.states_generated, res.diameter)
         == ST03_FIXPOINT and res.levels == ST03_SMALL_LEVELS,
         f"ST03 per-action: {res.distinct_states} {res.states_generated} "
         f"{res.diameter}")
    fused_host_reads(res, "ST03 per-action")
    out["ST03"] = info
    del eng

    print("phase 15d: RR05 small cfg, per-action run_fused(): it stops on "
          "NoLogDivergence at depth 17 with the per-action record's trace",
          flush=True)
    rr = RECOVERY["RR05"]
    inv, vdepth, _actions = rr["violation"]
    cex = json.load(open(RR05_COUNTEREXAMPLES))
    want = cex["per-action"]["steps"]
    eng, res, info = model_run("RR05", rr["module"], "small", "run_fused",
                               P["recovery_depth"], violation=inv,
                               commit="per-action",
                               label="RR05 small per-action")
    got = [e.action_name for e in res.trace[1:]]
    need(res.diameter == vdepth and res.levels == rr["small"][:vdepth]
         and len(res.trace) == vdepth + 1,
         f"RR05 per-action: diameter {res.diameter}, levels {res.levels}")
    need(got == [a for a, _lane in want], f"RR05 per-action trace {got}, "
         f"the record's {[a for a, _lane in want]}")
    # the record's (action, lane) steps replayed on the card give the
    # trace's states
    st = eng._init_flat[:1]
    for i, (name, lane) in enumerate(want):
        st = eng._materialize_one(st, eng.kern.action_names.index(name),
                                  lane)
        need(eng._decode(st) == res.trace[i + 1].state,
             f"RR05 per-action: step {i + 1} of the trace is not the "
             f"record's state")
    info["trace_actions"] = got
    out["RR05"] = info
    print(f"  {inv} at depth {res.diameter}, levels through {vdepth - 1} "
          f"the record's; the trace the per-action record's, step by step "
          f"(the fused commit's differs from step "
          f"{cex['first_step_unlike']}; their pointer tables from level "
          f"{cex['first_level_unlike']})", flush=True)
    del eng

    d9 = doc["paged_edges"]["per_action_depth"]
    print(f"phase 15e: PagedBFS(commit='per-action', edges=True), defect "
          f"config to depth {d9}", flush=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    eng = engine(PagedBFS, next_capacity=PAGED["next_capacity"],
                 edges=True, edge_capacity=PAGED["edge_capacity"])
    t0 = time.time()
    res = eng.run(max_depth=d9)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    pa_counts_ok(counts, "the per-action edge stream")
    c = res.metrics["counters"]
    need(0 < c["tile_reads"] <= c["tiles"], f"per-action paged: "
         f"{c['tile_reads']} host reads of a tile's results for "
         f"{c['tiles']} tiles")
    for k in ("fpset_store_gids", "fpset_probe", "edge_emit"):
        need(counts[k] > 0, f"{k} was not launched on the per-action "
             f"edge stream")
    need(res.ok and res.levels == LEVELS[:d9 + 1],
         f"per-action paged levels {res.levels}")
    n = res.distinct_states
    indptr, aid, tid = eng.edge_sink.finalize(n)
    src = np.repeat(np.arange(n), np.diff(indptr))
    slots, gids = eng.table["slots"], eng.table["gids"]
    occ = torch.nonzero((slots[:, 0] != 0) & (gids >= 0)).squeeze(1)
    need(occ.numel() == n, f"{occ.numel()} gids stored for {n} states")
    fp_dev = torch.zeros((n, 4), dtype=torch.int32, device="cuda")
    fp_dev[gids[occ].long()] = slots[occ, :4]
    got = triple_digest(fp_dev.cpu().numpy().view(np.uint32), src, aid, tid)
    want = tuple(doc["paged_edges"]["edges_to_depth"])
    need(got == want, f"per-action edges {got}, the fused paged run's "
         f"{want}")
    out["paged_edges"] = {"levels": res.levels, "wall_s": wall,
                          "edges": got[0]}
    print(f"  {got[0]} edges, fingerprint-labelled multiset that of phase "
          f"9c's out of levels 0-{d9 - 1}; wall {wall:.3f}s", flush=True)
    del eng

    print("phase 15f: K15 against its plain version", flush=True)
    rows = check_k15(rec)
    for k in rows:
        k["launches"] = out["launches"][k["kernel"]]
        need(k["launches"] > 0, f"{k['name']} was not launched on 15a's "
             f"run_fused")
    out["phase_s"] = time.time() - t_phase
    print(f"  phase 15 in {out['phase_s']:.1f}s", flush=True)
    return rows


class SimRec:
    """Keeps the committed chunks' histories of a DeviceSimulator run
    (its first ``rounds`` rounds) and, with ``record_k5``, the inputs of
    every K5 shared-layout call (an eager run)."""

    def __init__(self, sim, rounds=1, record_k5=False):
        from tpuvsr_torch.sim import rng
        self.sim, self.chunks, self.k5 = sim, [], []
        per = -(-SIM["depth"] // SIM["chunk"])
        orig = sim._chunk

        def chunk(*a):
            o = orig(*a)
            if not o[4] and not o[5].any() and \
                    len(self.chunks) < rounds * per:
                self.chunks.append((o[7][0].clone(), o[7][1].clone()))
            return o
        sim._chunk = chunk
        self._rng = rng
        self._saved = rng.choose_shared
        if record_k5:
            def choose(keys, t, en, lane_aid, wlogw=None):
                self.k5.append((keys.clone(), t.clone(), en.clone(),
                                lane_aid, None if wlogw is None
                                else wlogw.clone()))
                return self._saved(keys, t, en, lane_aid, wlogw)
            rng.choose_shared = choose

    def close(self):
        self._rng.choose_shared = self._saved

    def same(self, other):
        import torch
        return len(self.chunks) == len(other.chunks) and all(
            torch.equal(a, c) and torch.equal(b, d)
            for (a, b), (c, d) in zip(self.chunks, other.chunks))


def plain_sim_run(make, num, depth):
    """One eager run of a DeviceSimulator with the plain versions of its
    kernels on the card (the guard matrix, the successors, K5's shared
    draw and noise); returns its SimRec."""
    from tpuvsr_torch.sim import rng
    sim = make()
    sim.graphs = False
    k = sim.kern
    k.guard_matrix, k.successors = k.guard_matrix_plain, k.successors_plain
    saved = rng.choose_shared, rng.shared_noise
    rng.choose_shared = rng.choose_shared_plain
    rng.shared_noise = rng.shared_noise_plain
    rec = SimRec(sim)
    try:
        sim.run(num=num, depth=depth, seed=SIM["seed"])
    finally:
        rec.close()
        rng.choose_shared, rng.shared_noise = saved
        del k.guard_matrix, k.successors
    return rec


def check_k5_shared(rec, label, name="fleet_choose_shared"):
    """K5's shared layout against its plain version on every recorded
    call of a chunk, bit for bit; the call with the most enabled lanes
    timed with its bound."""
    import torch
    from tpuvsr_torch.sim import rng
    out = []
    err = 0
    for keys, t, en, lane_aid, wlogw in rec.k5:
        lk, ck = rng.choose_shared(keys, t, en, lane_aid, wlogw)
        lp, cp = rng.choose_shared_plain(keys, t, en, lane_aid, wlogw)
        err = max(err, max_abs(lk, lp), max_abs(ck, cp))
    need(err == 0, f"{label}: K5 shared differs from its plain version")
    keys, t, en, lane_aid, wlogw = max(rec.k5,
                                       key=lambda c: int(c[2].sum()))
    W, L = en.shape
    n_act = 0 if wlogw is None else wlogw.shape[1]
    lk, _ck = rng.choose_shared(keys, t, en, lane_aid, wlogw)
    aid = lane_aid.long()
    if n_act:
        act_en = torch.zeros((W, n_act), dtype=torch.int32,
                             device=en.device).index_add_(
            1, aid, en.to(torch.int32)) > 0
        chosen = int((en & (aid[None, :] == aid[lk.long()][:, None]))
                     .sum())
        n_g = int(act_en.sum())
        blocks = 2 * W + n_g + chosen
        nops = threefry_ops(blocks) + 60 * n_g + 2 * W * L
    else:
        blocks = int(en.sum())
        nops = threefry_ops(blocks) + 2 * W * L
    nbytes = W * L + W * n_act * 4 + L * 4 + 8 + 4 + W * 4 + W
    kernel_row(out, name,
               cuda_ms(lambda: rng.choose_shared(keys, t, en, lane_aid,
                                                 wlogw)),
               cuda_ms(lambda: rng.choose_shared_plain(keys, t, en,
                                                       lane_aid, wlogw),
                       reps=5), err, nbytes, nops,
               extra={"shape": [W, L], "n_act": n_act,
                      "enabled": int(en.sum()), "blocks": blocks,
                      "calls_checked": len(rec.k5)}, label=label)
    return out


def sim_phase(args, doc):
    """Phase 16: DeviceSimulator.  Returns K5's shared-layout rows."""
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_sim import DeviceSimulator
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.sim import rng
    from tpuvsr_torch.sim.defect_hunt import WEIGHTS
    S = SIM
    t_phase = time.time()
    out = doc["sim"] = {}
    rows = []
    defect = load_binding(DEFECT, "VSR")
    W = S["walkers"]

    def make(binding=defect, **kw):
        kw.setdefault("dispatch", "dense")
        return lambda: DeviceSimulator(binding, max_msgs=S["max_msgs"],
                                       walkers=W, chunk_steps=S["chunk"],
                                       device="cuda", **kw)

    def timed(key, mk, num, depth, want_kernels, max_seconds=None):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        sim = mk()
        rec = SimRec(sim)
        t0 = time.time()
        try:
            res = sim.run(num=num, depth=depth, seed=S["seed"],
                          max_seconds=max_seconds)
        finally:
            rec.close()
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        for k in want_kernels:
            need(counts[k] > 0, f"{k} was not launched on {key}")
        need(counts["fleet_choose"] == 0 and counts["fleet_swarm_noise"]
             == 0, f"the fleet's K5 layout was launched on {key}")
        c = res.metrics["counters"]
        need(c["host_reads"] == c["chunks"], f"{key}: host reads {c}")
        info = {"ok": res.ok, "walks": res.walks, "steps": res.steps,
                "violated": res.violated_invariant, "wall_s": wall,
                "steps_per_s": res.steps / wall,
                "walks_per_s": res.walks / wall, "launches": counts,
                "metrics": res.metrics}
        out[key] = info
        print(f"  {key}: walks {res.walks} steps {res.steps} wall "
              f"{wall:.3f}s steps/s {info['steps_per_s']:.1f} walks/s "
              f"{info['walks_per_s']:.1f} {res.violated_invariant or ''}; "
              f"chunks {c.get('chunks')} graph_captures "
              f"{c.get('graph_captures')}", flush=True)
        return sim, res, rec, counts

    vsr_k = ("vsr_guards", "fleet_choose_shared", "vsr_actions")
    for key, kw, name in (
            ("16a", {}, "fleet_choose_shared"),
            ("16b", {"action_weights": [1.0] * 19,
                     "swarm_sigma": S["sigma"], "dispatch": "grouped"},
             "fleet_choose_shared (weighted)")):
        print(f"phase {key}: DeviceSimulator, defect config, {W} walkers, "
              f"chunk {S['chunk']}, depth {S['depth']}, seed {S['seed']}, "
              f"{S['rounds']} rounds, {kw or 'uniform'}", flush=True)
        # the first chunk eagerly on the kernels, K5's inputs recorded
        sim = make(**kw)()
        sim.graphs = False
        krec = SimRec(sim, record_k5=True)
        try:
            sim.run(num=W, depth=S["chunk"], seed=S["seed"])
        finally:
            krec.close()
        rows += check_k5_shared(krec, name)
        if kw:
            # the first round's key and its uniform log-weights
            wk = rng.split(rng.prng_key(S["seed"]))[1].cuda()
            logw = torch.zeros((19,), dtype=torch.float32, device="cuda")
            a = rng.shared_noise(wk, logw, S["sigma"], W)
            b = rng.shared_noise_plain(wk, logw, S["sigma"], W)
            err = max_abs(a.view(torch.int32), b.view(torch.int32))
            kernel_row(rows, "fleet_noise_shared",
                       cuda_ms(lambda: rng.shared_noise(wk, logw,
                                                        S["sigma"], W)),
                       cuda_ms(lambda: rng.shared_noise_plain(
                           wk, logw, S["sigma"], W), reps=5), err,
                       8 + 19 * 4 + W * 19 * 4,
                       threefry_ops(W * 19) + 45 * W * 19,
                       extra={"shape": [W, 19], "sigma": S["sigma"]})
        del sim, krec
        want = vsr_k + (("fleet_noise_shared",) if kw else ())
        sim, res, rec, counts = timed(key, make(**kw), S["rounds"] * W,
                                      S["depth"], want)
        for r in rows:
            if r["kernel"] in counts and r["launches"] is None:
                r["launches"] = counts[r["kernel"]]
        need(res.ok and res.walks == S["rounds"] * W,
             f"{key}: {res.violated_invariant} after {res.walks} walks")
        plain = plain_sim_run(make(**dict(kw, dispatch="dense")), W,
                              S["depth"])
        need(rec.same(plain), f"{key}: the first round's histories differ "
             f"from the eager plain run's")
        print(f"  the first round's (action, param) histories those of an "
              f"eager dense run of the plain versions on the card", flush=True)
        del sim, rec, plain

    print(f"phase 16c: DeviceSimulator, guided (split_beta 1.5, the hunt's "
          f"weights, swarm {S['guided_sigma']}), max_seconds "
          f"{S['guided_s']}", flush=True)
    mk = make(action_weights=WEIGHTS, swarm_sigma=S["guided_sigma"],
              guided=True, split_beta=1.5)
    sim, res, _rec, _c = timed("16c", mk, 10 ** 9, S["depth"], vsr_k,
                               max_seconds=S["guided_s"])
    out["16c"]["best_score"] = sim.best_score
    if not res.ok:
        need(res.violated_invariant == "AcknowledgedWriteNotLost",
             f"16c: {res.violated_invariant}")
        check_replay(sim, res.trace)
        out["16c"]["event"] = sim.event
        out["16c"]["trace_len"] = len(res.trace)
        print(f"  AcknowledgedWriteNotLost found after {res.elapsed:.1f}s "
              f"({res.walks} walks completed before its round), walker "
              f"{sim.event['walker']}, step {sim.event['step']}; the trace "
              f"replays and its last state fails the invariant", flush=True)
    else:
        print(f"  no violation in {res.elapsed:.1f}s ({res.walks} walks); "
              f"best hunt score {sim.best_score}", flush=True)
    del sim

    st03 = load_binding(ST03_SHIPPED, "VR_STATE_TRANSFER")
    print(f"phase 16d: DeviceSimulator, ST03 shipped cfg, {W} walkers, "
          f"depth {S['st03_depth']}, one round", flush=True)
    fam = family_kernels()["ST03"]
    sim, res, rec, counts = timed(
        "16d", make(st03), W, S["st03_depth"],
        (fam[0], fam[1], "fleet_choose_shared"))
    for k in VSR_KERNELS:
        need(counts[k] == 0, f"{k} was launched on 16d")
    need(res.walks == W, f"16d: {res.violated_invariant} {res.walks}")
    plain = plain_sim_run(make(st03), W, S["st03_depth"])
    need(rec.same(plain), "16d: histories differ from the eager plain "
         "run's")
    print("  histories those of an eager run of the plain versions on the "
          "card", flush=True)
    del sim, rec, plain
    out["phase_s"] = time.time() - t_phase
    print(f"  phase 16 in {out['phase_s']:.1f}s", flush=True)
    return rows


VALIDATE = {"stub_traces": 1024, "stub_depth": 6, "stub_seed": 0,
            "mutate": (11, 2), "max_msgs": 48, "walks": 1024,
            "walk_depth": 12, "walk_seed": 0, "walk_batch": 32,
            "replayed": 16,
            "golden_cap": 256}
# walk_depth: DeviceSimulator walks are cut from 40 steps to 12.  The
# candidate sets of action-only walks about double a step (on the H100,
# the largest set by depth 8: 588, 10: 2,436, 12: 5,217, 14: 11,982; by
# 16 one outgrows a cap of 16,384), so a depth-40 round cannot be held;
# at 12 all 1024 walks validate (cand_cap 8192) in rounds of 32 traces
# the golden trace's candidate-set sizes after each of its 29 events,
# action names observed only (the plain step on the CPU; held there by
# tests/test_torch_validate_vsr.py)
GOLDEN_SIZES = [2, 6, 6, 6, 6, 12, 18, 48, 120, 228, 108, 156, 60, 36, 12,
                24, 48, 36, 72, 216, 216, 72, 144, 72, 144, 24, 24, 24, 48]
GOLDEN_MUTANT = {"trace": "mutant", "step": 1, "candidates": 2,
                 "enabled": ["ReceiveClientRequest", "ReceiveHigherSVC",
                             "TimerSendSVC"]}
K16_KERNELS = ("validate_select", "validate_commit")


class K16Recorder:
    """Keeps, for one run, the inputs of the K16 select and commit calls
    with the most queue items (the round's state copied before the
    commit updates it)."""

    def __init__(self):
        from tpuvsr_torch.validate import batch as vb
        self.vb, self.sel, self.com = vb, None, None
        self._saved = vb.select, vb.commit
        sel0, com0 = self._saved

        def select(en, alive, div_at, tlen, aid, lane_aid, lane_prm, K, s):
            q, roff = sel0(en, alive, div_at, tlen, aid, lane_aid,
                           lane_prm, K, s)
            if self.sel is None or q["pidx"].shape[0] > self.sel[0]:
                self.sel = (q["pidx"].shape[0],
                            [x.clone() for x in (en, alive, div_at, tlen,
                                                 aid, lane_aid, lane_prm)],
                            K, s)
            return q, roff

        def commit(st, roff, succ, *rest):
            if self.com is None or succ.shape[0] > self.com[0]:
                self.com = (succ.shape[0],
                            {k: v.clone() for k, v in st.items()},
                            [x.clone() if hasattr(x, "clone") else x
                             for x in (roff, succ) + rest])
            return com0(st, roff, succ, *rest)
        vb.select, vb.commit = select, commit

    def close(self):
        self.vb.select, self.vb.commit = self._saved


def check_k16(rec, label):
    """K16's select and commit against their plain versions on the card,
    on the recorded calls, bit for bit; each timed with its bound."""
    import torch
    vb = rec.vb
    rows = []
    Q, args, K, s = rec.sel
    q, roff = vb.select(*args, K, s)
    qp, rp = vb.select_plain(*args, K, s)
    same = torch.equal(roff, rp) and all(torch.equal(q[k], qp[k])
                                         for k in q)
    err = 0 if same else max([max_abs(roff, rp)] + [
        max_abs(q[k], qp[k]) if q[k].shape == qp[k].shape else 1 << 30
        for k in q])
    en, alive, div_at, tlen = args[:4]
    R, L = en.shape
    T = div_at.shape[0]
    # the guard rows read are those of live candidates of active traces;
    # the queue's items are three int32 words
    act = (s < tlen) & (div_at < 0)
    rows_read = int((alive.view(T, K) & act[:, None]).sum())
    nbytes = (rows_read * L + R + 3 * T * 4 + 2 * L * 4 + 12 * Q
              + 8 * (R + 1))
    # timed with the queue's size given, so without the host read that
    # sizes the queue on the main path (one a step)
    kernel_row(rows, "validate_select",
               cuda_ms(lambda: vb._select_kernel(*args, K, s, Q=Q)),
               cuda_ms(lambda: vb.select_plain(*args, K, s), reps=5), err,
               nbytes, 0, extra={"shape": [R, L], "traces": T, "K": K,
                                 "queue": Q, "rows_read": rows_read},
               label=f"validate_select ({label})")
    Qc, st0, cargs = rec.com
    roff, succ, en2, errw, fp, en, o_lo, o_hi, obs_w, obs_v, s, last, \
        step_end = cargs

    def fresh():
        return {k: v.clone() for k, v in st0.items()}
    a, b = fresh(), fresh()
    vb.commit(a, *cargs)
    vb.commit_plain(b, *cargs)
    err = max(max_abs(a[k], b[k]) for k in a)
    T = st0["div_at"].shape[0]
    R, W = st0["cands"].shape
    K = R // T
    L = en.shape[1]
    act = (s < st0["tlen"]) & (st0["div_at"] < 0)
    upd = act & (a["div_at"] < 0)
    div_now = act & (a["div_at"] >= 0)
    kept = int(a["alive"].view(T, K)[upd].sum())
    npin = (o_hi - o_lo).clamp(min=0).long()
    nobs = int(npin.sum())
    # each item's pinned words, read by the observation filter
    items = (roff[K::K] - roff[:-1:K]).long()
    pinned = int((items * npin).sum())
    nupd = int(upd.sum())
    common = (Qc * (1 + 4 + 16) + 4 * pinned + 8 * (R + 1) + 8 * nobs
              + kept * W * 4 + R + int(div_now.sum()) * K * L
              + T * (4 * 4 + L))
    # the dense layout writes every slot of an updated trace (the kept
    # rows and zeros); the kept bytes alone are the kept rows and flags
    nbytes = common + nupd * K * (W * 4 + 1)
    kept_bound = bound(common + kept * W * 4 + nupd * K, 0)[0]
    work = fresh()
    saved = fresh()

    def restore():
        for k in work:
            work[k].copy_(saved[k])
    kernel_row(rows, "validate_commit",
               cuda_ms(lambda: vb.commit(work, *cargs), pre=restore),
               cuda_ms(lambda: vb.commit_plain(work, *cargs), reps=5,
                       pre=restore), err, nbytes, 0,
               extra={"shape": [R, W], "traces": T, "K": K, "queue": Qc,
                      "kept": kept, "diverged": int(div_now.sum()),
                      "updated": nupd, "kept_bound_ms": kept_bound},
               label=f"validate_commit ({label})")
    print(f"  validate_commit ({label}): the kept bytes' bound "
          f"{kept_bound:.5f} ms ({kept} kept rows; the dense layout "
          f"writes all {nupd * K} slots of the {nupd} updated traces)",
          flush=True)
    return rows


def validate_phase(args, doc):
    """Phase 17: trace validation (K16).  Returns K16's rows."""
    import numpy as np
    import torch
    from types import SimpleNamespace
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_sim import (DeviceSimulator,
                                                materialize_walk)
    from tpuvsr_torch.engine.spec import InitShim, load_binding
    from tpuvsr_torch.frontend.cfg import parse_cfg_file
    from tpuvsr_torch.frontend.parser import parse_module_text
    from tpuvsr_torch.frontend.trace_parse import parse_trace_file
    from tpuvsr_torch.interp.evalr import Evaluator
    from tpuvsr_torch.testing import (counter_spec, stub_trace_records,
                                      stub_validator)
    from tpuvsr_torch.validate import (BatchValidator, Trace, TraceEvent,
                                       host_validate_batch,
                                       traces_from_records)
    V = VALIDATE
    t_phase = time.time()
    out = doc["validate"] = {}
    rows = []

    def timed(key, make, traces, want):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        plain0 = plain_calls()
        t0 = time.time()
        bv = make()
        res = bv.run(traces)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        for k in want:
            need(counts[k] > 0, f"{k} was not launched on {key}")
        need(plain_calls() == plain0, f"the plain action functions ran "
             f"on {key}")
        events = sum(len(t.events) for t in traces)
        g = res.metrics["gauges"]
        info = {"traces": len(traces), "events": events, "wall_s": wall,
                "traces_per_s": len(traces) / wall,
                "events_per_s": events / wall, "accepted": res.accepted,
                "divergences": len(res.divergences),
                "cand_cap": g["cand_cap"], "max_msgs": g["max_msgs"],
                "max_candidates": g["max_candidates"],
                "counters": res.metrics["counters"],
                "launches": {k: counts[k] for k in counts if counts[k]}}
        out[key] = info
        print(f"  {key}: {len(traces)} traces, {events} events, wall "
              f"{wall:.3f}s, traces/s {info['traces_per_s']:.1f}, events/s "
              f"{info['events_per_s']:.1f}, accepted {res.accepted}, "
              f"divergences {len(res.divergences)}, cand_cap "
              f"{g['cand_cap']}, max_msgs {g['max_msgs']}, largest set "
              f"{g['max_candidates']}; counters {res.metrics['counters']}; "
              f"K16 launches {[counts[k] for k in K16_KERNELS]}", flush=True)
        return bv, res, counts

    # -- 17a: the counter stub, parsed by the port's frontend ----------
    spec = counter_spec()
    print(f"phase 17a: the counter stub (parsed by the port's frontend), "
          f"{V['stub_traces']} traces of depth {V['stub_depth']}, "
          f"confirm=True", flush=True)
    stub_rec = None
    for name, kw in (("genuine", {}), ("mutated", {"mutate": V["mutate"]}),
                     ("partial", {"drop_vars": ("y",)}),
                     ("blank", {"blank_every": 3})):
        traces = traces_from_records(stub_trace_records(
            n=V["stub_traces"], depth=V["stub_depth"], seed=V["stub_seed"],
            **kw), spec)
        if name == "mutated":
            stub_rec = K16Recorder()
        try:
            _bv, res, counts = timed(f"17a_{name}", lambda: stub_validator(
                batch=V["stub_traces"], device="cuda"), traces, K16_KERNELS)
        finally:
            if stub_rec is not None and name == "mutated":
                stub_rec.close()
        if name == "mutated":
            stub_launches = {k: counts[k] for k in K16_KERNELS}
        host = host_validate_batch(spec, traces)
        need(res.divergences == host.divergences
             and res.accepted == host.accepted,
             f"17a {name}: the card's report differs from the host "
             f"validator's: {res.divergences[:2]} / {host.divergences[:2]}")
        if name == "mutated":
            i, st = V["mutate"]
            need([(d["trace"], d["step"]) for d in res.divergences]
                 == [(f"t-{i:04d}", st)],
                 f"17a: {[(d['trace'], d['step']) for d in res.divergences]}")
        else:
            need(res.ok, f"17a {name}: {res.divergences[:2]}")
    print(f"  reports equal the host validator's; t-{V['mutate'][0]:04d} "
          f"diverges at event {V['mutate'][1]}", flush=True)

    # -- 17b: VSR at full width ----------------------------------------
    cfg = parse_cfg_file(DEFECT)
    mod = parse_module_text("---- MODULE VSR ----\nCONSTANTS "
                            + ", ".join(cfg.constants) + "\n====\n")
    entries = parse_trace_file(
        os.path.join(ROOT, "examples", "found_violation_trace.txt"),
        SimpleNamespace(cfg=cfg, ev=Evaluator(mod, cfg.constants)))
    binding = load_binding(DEFECT, "VSR")
    vspec = InitShim(binding, entries[0].state)
    acts = [e.action_name for e in entries[1:]]
    golden = Trace("golden", [TraceEvent(action=a) for a in acts])
    mutant = Trace("mutant", [TraceEvent(action=a) for a in
                              acts[:1] + ["ReceivePrepareOkMsg"] + acts[1:]])
    print(f"phase 17b: VSR, {DEFECT.split(os.sep)[-1]}, MAX_MSGS "
          f"{V['max_msgs']}: the golden trace (29 events, actions observed) "
          f"and its mutant; confirm=False (VSR's .tla is not in the "
          f"repository, so the interpreter cannot confirm a divergence)",
          flush=True)
    vsr_k = ("vsr_guards", "vsr_actions", "vsr_fp_incremental") + K16_KERNELS

    def vsr_validator(batch):
        return lambda: BatchValidator(vspec, batch=batch,
                                      max_msgs=V["max_msgs"], confirm=False,
                                      device="cuda")
    bv, res, _c = timed("17b_golden", vsr_validator(2), [golden, mutant],
                        vsr_k)
    sizes = bv.sizes["golden"]
    print(f"  golden: candidate sets by event {sizes}, the largest "
          f"{max(sizes)}; cand_cap {bv.K}", flush=True)
    out["17b_golden"]["sizes"] = sizes
    need(sizes == GOLDEN_SIZES, f"17b: golden sizes {sizes}")
    need(bv.K == V["golden_cap"], f"17b: cand_cap {bv.K}")
    need(res.accepted == 1 and len(res.divergences) == 1,
         f"17b: {res.divergences}")
    d = res.divergences[0]
    got = {"trace": d["trace"], "step": d["step"],
           "candidates": d["candidates"],
           "enabled": [e["action"] for e in d["enabled"]]}
    print(f"  mutant: {got}", flush=True)
    need(got == GOLDEN_MUTANT, f"17b: mutant {got}")

    # genuine walks of the defect config, action names observed
    sim = DeviceSimulator(binding, max_msgs=V["max_msgs"],
                          walkers=V["walks"], chunk_steps=V["walk_depth"],
                          dispatch="dense", device="cuda")
    chunks = []
    orig = sim._chunk

    def chunk(*a):
        o = orig(*a)
        if not o[4] and not o[5].any():
            chunks.append((o[7][0].clone(), o[7][1].clone()))
        return o
    sim._chunk = chunk
    t0 = time.time()
    sres = sim.run(num=V["walks"], depth=V["walk_depth"],
                   seed=V["walk_seed"])
    aids = torch.cat([c[0] for c in chunks]).cpu().numpy()
    prms = torch.cat([c[1] for c in chunks]).cpu().numpy()
    st0 = sim.codec.init_dense()
    enc0 = sim.codec.encode(entries[0].state)
    need(all(np.array_equal(np.asarray(enc0[k]), np.asarray(st0[k]))
             for k in st0), "17b: the golden state 0 is not VSR's Init")
    names = sim.kern.action_names
    walks = []
    for w in range(V["walks"]):
        col = aids[:, w]
        n = int(np.argmax(col < 0)) if (col < 0).any() else len(col)
        walks.append(Trace(f"w-{w:04d}", [TraceEvent(action=names[a])
                                          for a in col[:n]]))
    # a sample re-executed through the kernel (materialize_walk): every
    # recorded lane enabled, the actions the recorded ones
    for w in range(V["replayed"]):
        ent = materialize_walk(sim.kern, sim.codec, st0, aids[:, w],
                               prms[:, w], V["walk_depth"], "cuda")
        need([e.action_name for e in ent[1:]]
             == [ev.action for ev in walks[w].events],
             f"17b: walk {w} does not replay")
    out["walks_s"] = time.time() - t0
    lens = [len(t.events) for t in walks]
    print(f"  {len(walks)} DeviceSimulator walks (seed {V['walk_seed']}, "
          f"depth {V['walk_depth']}, {sres.violated_invariant or 'no'} "
          f"violation; {V['replayed']} re-executed by materialize_walk) in "
          f"{out['walks_s']:.1f}s; events {min(lens)}-{max(lens)}",
          flush=True)
    del sim, chunks
    walk_rec = K16Recorder()
    try:
        BatchValidator(vspec, batch=V["walk_batch"], max_msgs=V["max_msgs"],
                       confirm=False, device="cuda").run(
                           walks[:V["walk_batch"]])
    finally:
        walk_rec.close()
    bv, res, counts = timed("17b_walks", vsr_validator(V["walk_batch"]),
                            walks, vsr_k)
    need(res.ok and res.accepted == len(walks),
         f"17b: genuine walks diverged: {res.divergences[:3]}")
    walk_launches = {k: counts[k] for k in K16_KERNELS}

    # -- 17c: K16 against its plain version ----------------------------
    print("phase 17c: K16 against its plain version on the card",
          flush=True)
    for rec, label, launches in ((stub_rec, "stub", stub_launches),
                                 (walk_rec, "VSR walks", walk_launches)):
        for r in check_k16(rec, label):
            r["launches"] = launches[r["kernel"]]
            rows.append(r)
    del stub_rec, walk_rec
    out["phase_s"] = time.time() - t_phase
    print(f"  phase 17 in {out['phase_s']:.1f}s", flush=True)
    return rows


# phase 18: speclint, the bounds facts and the ample-set reduction (K17).
# 18b drives the counter stub's inv_free variant at Limit 2047: 2048^2 =
# 4,194,304 states unreduced, 2 * 2047 + 1 = 4,095 reduced (one a
# level); run() with POR on, two host reads a level, runs at Limit 1023
# (2,047 levels; 12-30 s at 2047, PERF.md §4), held to the same formulas;
# 18c's stress shape is a tile of 8,192 rows over 64 one-lane actions, a
# queue of 65,536 items and a 2^22-slot table half full
POR = {"limit": 2047, "run_limit": 1023, "tile": 512, "fpset": 1 << 24,
       "next": 1 << 14,
       "rows": 8192, "actions": 64, "queue": 1 << 16, "slots": 1 << 22,
       "pdepth": 5, "seed": 0}
K17_KERNELS = ("por_cand", "por_probe", "por_keep")


class K17Recorder:
    """Keeps, for one run(), the inputs of the K17 chain of the tile with
    the most queue items: cand's guard rows, and probe's table, marker
    column, fingerprints and queue (cloned before K1's insert)."""

    def __init__(self):
        from tpuvsr_torch.engine import device_bfs as D
        self.D, self.case = D, None
        self._saved = D.por_cand, D.por_probe
        cand0, probe0 = self._saved
        pending = {}

        def cand(en, valid, segs, pt, P):
            pending["cand"] = (en.clone(), valid.clone(), segs, pt)
            return cand0(en, valid, segs, pt, P)

        def probe(table, gids, fps, en2, q, P, pdepth):
            if self.case is None or \
                    fps.shape[0] > self.case["fps"].shape[0]:
                en, valid, segs, pt = pending["cand"]
                self.case = {
                    "en": en, "valid": valid, "segs": segs, "pt": pt,
                    "slots": table["slots"].clone(), "gids": gids.clone(),
                    "fps": fps.clone(), "en2": en2.clone(),
                    "q": {k: v.clone() for k, v in q.items()},
                    "pdepth": pdepth.clone()}
            return probe0(table, gids, fps, en2, q, P, pdepth)
        D.por_cand, D.por_probe = cand, probe

    def close(self):
        self.D.por_cand, self.D.por_probe = self._saved


def k17_stress_case():
    """18c's stress inputs, made on the card from POR["seed"]: a guard
    matrix of POR["rows"] rows over POR["actions"] one-lane actions
    (an eighth enabled), a matrix with ineligible all-False rows, the
    matrix's compaction as the queue (POR["queue"] items, action-major),
    a table of POR["slots"] slots half full with markers over pdepth-2
    .. pdepth+1 and -1, and half the queue's fingerprints in it."""
    import torch
    from tpuvsr_torch.engine.fpset import empty_table, insert_core, \
        store_gids
    from tpuvsr_torch.engine.tile import Segments, por_tables
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(POR["seed"])
    T, A, Q, cap, pd = (POR["rows"], POR["actions"], POR["queue"],
                        POR["slots"], POR["pdepth"])

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)
    en = rand(T, A) < Q / (T * A)
    valid = rand(T) < 0.97
    amat = rand(A, A) < 0.97
    amat[rand(A) < 0.3] = False                  # ineligible rows
    eligible = amat.any(dim=1)
    amat[torch.arange(A, device=dev), torch.arange(A, device=dev)] |= \
        eligible
    a_i, r_i = torch.nonzero((en & valid[:, None]).T, as_tuple=True)
    n = min(Q, int(a_i.shape[0]))
    q = {"pidx": torch.full((Q,), T - 1, dtype=torch.int32, device=dev),
         "aid": torch.full((Q,), A - 1, dtype=torch.int32, device=dev),
         "lane": torch.zeros((Q,), dtype=torch.int32, device=dev),
         "ok": torch.zeros((Q,), dtype=torch.bool, device=dev)}
    q["pidx"][:n] = r_i[:n].to(torch.int32)
    q["aid"][:n] = a_i[:n].to(torch.int32)
    q["ok"][:n] = True
    table = empty_table(cap, dev)
    n_in = cap // 2
    fps_in = ints(-(1 << 31), 1 << 31, 4 * n_in).to(torch.int32).view(
        n_in, 4)
    ones = torch.ones((n_in,), dtype=torch.bool, device=dev)
    _t, fresh, ovf = insert_core(table, fps_in, ones)
    need(int(ovf) == 0, "18c: the stress table overflowed")
    marks = ints(pd - 2, pd + 2, n_in).to(torch.int32)
    marks[rand(n_in) < 0.1] = -1
    gids = torch.zeros((cap,), dtype=torch.int32, device=dev)
    store_gids(table["slots"], gids, fps_in, marks, fresh)
    fps = ints(-(1 << 31), 1 << 31, 4 * Q).to(torch.int32).view(Q, 4)
    hit = rand(Q) < 0.5
    fps[hit] = fps_in[ints(0, n_in, int(hit.sum()))]
    return {"en": en, "valid": valid,
            "segs": Segments(list(range(A)), [1] * A, [0] * A, dev),
            "pt": por_tables(amat.cpu(), dev), "slots": table["slots"],
            "gids": gids, "fps": fps.contiguous(),
            "en2": (rand(Q) < 0.9) & q["ok"], "q": q,
            "pdepth": torch.tensor([pd], dtype=torch.int64, device=dev)}


def k17_chain(c, fns):
    """cand, probe and keep (the wrappers or the plain versions ``fns``)
    on a recorded case, in the engines' order; returns the outputs after
    each stage."""
    import torch
    from tpuvsr_torch.engine.tile import por_buffers
    cand, probe, keep = fns
    T, total = c["en"].shape[0], c["fps"].shape[0]
    P = por_buffers(T, total, len(c["segs"].host), "cuda")
    cand(c["en"], c["valid"], c["segs"], c["pt"], P)
    s1 = {k: v.clone() for k, v in P.items()}
    probe({"slots": c["slots"]}, c["gids"], c["fps"], c["en2"], c["q"], P,
          c["pdepth"])
    s2 = {k: v.clone() for k, v in P.items()}
    keep(c["en2"], c["q"], P, c["pdepth"])
    torch.cuda.synchronize()
    return s1, s2, {k: v.clone() for k, v in P.items()}


def k17_probe_steps(c, P):
    """(ample items, slot rows they read, of them found) of the probe:
    each ample item walks its chain until its own slot or an empty one,
    as the kernel does (the recorded chain lengths of the bound)."""
    import torch
    from tpuvsr_torch.engine.fpset import MAX_PROBES, _keyed
    from tpuvsr_torch.engine.pack import to_u32
    q = c["q"]
    pidx = q["pidx"].long()
    amp = (c["en2"] & q["ok"] & P["has_cand"][pidx]
           & (q["aid"] == P["aid_star"][pidx]))
    slots = c["slots"]
    capm = slots.shape[0] - 1
    keyed, h0 = _keyed(c["fps"])
    unresolved = amp.clone()
    steps = found = 0
    for t in range(MAX_PROBES):
        n = int(unresolved.sum())
        if n == 0:
            break
        steps += n
        cur = slots[(h0 + t) & capm]
        mine = unresolved & (to_u32(cur[:, :4]) == keyed).all(dim=1)
        found += int(mine.sum())
        unresolved = unresolved & ~mine & (cur[:, 0] != 0)
    return int(amp.sum()), steps, found


def check_k17(c, label):
    """K17's three entries against their plain versions on the card, bit
    for bit at each stage of the chain, then each timed with its bound
    (bytes: the guard rows or queue items read, 16-byte fingerprints and
    one 20-byte slot row a probe step of the recorded chains)."""
    from tpuvsr_torch.engine import tile as TL
    rows = []
    kern = k17_chain(c, (TL.por_cand, TL.por_probe, TL.por_keep))
    plain = k17_chain(c, (TL.por_cand_plain, TL.por_probe_plain,
                          TL.por_keep_plain))
    errs = [max(max_abs(a[k], b[k]) for k in a)
            for a, b in zip(kern, plain)]
    T, L = c["en"].shape
    total = c["fps"].shape[0]
    n_act = len(c["segs"].host)
    P = kern[1]
    n_amp, steps, found = k17_probe_steps(c, kern[0])
    shape = {"rows": T, "lanes": L, "actions": n_act, "queue": total,
             "slots": c["slots"].shape[0]}
    print(f"  {label}: {shape}; rows with a candidate "
          f"{int(P['has_cand'].sum())}, vetoed by C3 "
          f"{int((P['amp_bad'] != 0).sum())}; ample items {n_amp}, probe "
          f"steps {steps}, found {found}; kept {int(kern[2]['keep'].sum())} "
          f"of {int((c['en2'] & c['q']['ok']).sum())}", flush=True)
    Pc = {k: v.clone() for k, v in P.items()}
    args_c = (c["en"], c["valid"], c["segs"], c["pt"], Pc)
    kernel_row(rows, "por_cand", cuda_ms(lambda: TL.por_cand(*args_c)),
               cuda_ms(lambda: TL.por_cand_plain(*args_c), reps=5),
               errs[0], T * L + T + n_act * 24 + T * 13 + n_act * 8 + 8, 0,
               extra={"shape": shape}, label=f"por_cand ({label})")
    table = {"slots": c["slots"]}
    args_p = (table, c["gids"], c["fps"], c["en2"], c["q"], Pc,
              c["pdepth"])
    kernel_row(rows, "por_probe", cuda_ms(lambda: TL.por_probe(*args_p)),
               cuda_ms(lambda: TL.por_probe_plain(*args_p), reps=5),
               errs[1], total * 10 + T * 5 + n_amp * 16 + steps * 20
               + found * 4 + T * 4 + 8, 0,
               extra={"shape": shape, "ample_items": n_amp,
                      "probe_steps": steps, "found": found},
               label=f"por_probe ({label})")
    args_k = (c["en2"], c["q"], Pc, c["pdepth"])
    kernel_row(rows, "por_keep", cuda_ms(lambda: TL.por_keep(*args_k)),
               cuda_ms(lambda: TL.por_keep_plain(*args_k), reps=5),
               errs[2], total * 10 + T * 13 + total * 5 + n_act * 8 + 8, 0,
               extra={"shape": shape}, label=f"por_keep ({label})")
    return rows


def por_phase(args, doc):
    """Phase 18: speclint, bounds facts and the ample-set reduction
    (K17).  Returns K17's rows."""
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.analysis import preflight
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    from tpuvsr_torch.engine.paged_bfs import PagedBFS
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.testing import (
        POR_STUB_DISTINCT, POR_STUB_FULL, POR_STUB_KEPT, POR_STUB_LEVELS,
        STUB_DISTINCT, STUB_LEVELS, counter_spec, stub_device_engine,
        stub_sym_engine, sym_pair_spec)
    t_phase = time.time()
    out = doc["por"] = {}

    def drive(key, make, entry, k17, **run_kw):
        """One main-path run, launch counts reset just before and read
        just after: K17 must have launched (``k17``) or not."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        eng = make(PagedBFS if entry == "paged" else None)
        res = (eng.run_fused(**run_kw) if entry == "run_fused"
               else eng.run(**run_kw))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        got = {k: counts[k] for k in K17_KERNELS}
        need(all(got.values()) if k17 else not any(got.values()),
             f"{key}: K17 launches {got}")
        out[key] = {"distinct": res.distinct_states,
                    "generated": res.states_generated,
                    "levels": len(res.levels), "error": res.error,
                    "violated": res.violated_invariant,
                    "kept": eng._por_kept, "full": eng._por_full,
                    "amp": eng._por_amp, "wall_s": wall, "k17": got}
        return eng, res, got

    def inv_free(por, **kw):
        return lambda cls: stub_device_engine(
            spec=counter_spec(inv_free=True), device="cuda", por=por,
            cls=cls, **({"chunk_tiles": 1} if cls else {}), **kw)

    # -- 18a: the stub oracles through run(), run_fused() and PagedBFS --
    print("phase 18a: the stub oracles (speclint's facts, the reduction) "
          "through run(), run_fused() and PagedBFS", flush=True)
    stub_rec = None
    for entry in ("run", "run_fused", "paged"):
        if entry == "run":
            stub_rec = K17Recorder()
        try:
            eng, res, got = drive(f"18a_inv_free_on_{entry}",
                                  inv_free("on"), entry, True,
                                  check_deadlock=True)
        finally:
            if entry == "run":
                stub_rec.close()
        if entry == "run":
            stub_launches = got
        need(res.distinct_states == POR_STUB_DISTINCT
             and res.levels == POR_STUB_LEVELS
             and (eng._por_kept, eng._por_full) == (POR_STUB_KEPT,
                                                    POR_STUB_FULL)
             and res.error == "deadlock"
             and res.deadlock_state == {"x": 3, "y": 3},
             f"18a inv_free POR on ({entry}): {out[f'18a_inv_free_on_{entry}']}"
             f" {res.deadlock_state}")
        eng, res, _g = drive(f"18a_inv_free_off_{entry}", inv_free("off"),
                             entry, False, check_deadlock=True)
        need(res.distinct_states == STUB_DISTINCT
             and res.levels == STUB_LEVELS and res.error == "deadlock"
             and res.deadlock_state == {"x": 3, "y": 3},
             f"18a inv_free POR off ({entry}): {res.distinct_states} "
             f"{res.levels}")
        eng, res, _g = drive(f"18a_sympair_{entry}", lambda cls: (
            stub_sym_engine(symmetry=False, por="on", spec=sym_pair_spec(),
                            device="cuda", cls=cls)), entry, True)
        need(res.ok and res.distinct_states == 13
             and res.levels == [1, 3, 9],
             f"18a SymPair ({entry}): {res.distinct_states} {res.levels}")
    print(f"  inv_free: POR on {POR_STUB_DISTINCT} distinct, levels "
          f"{POR_STUB_LEVELS}, kept/full {POR_STUB_KEPT}/{POR_STUB_FULL}, "
          f"deadlock at (3, 3); POR off {STUB_DISTINCT}, {STUB_LEVELS}, the "
          f"same deadlock; SymPair (symmetry off) 13, [1, 3, 9]: through "
          f"all three entry points; K17 {stub_launches} in the run() leg "
          f"and never with POR off", flush=True)
    want = stub_device_engine(spec=counter_spec(inv_x_bound=2),
                              inv_x_bound=2, device="cpu", por="on").run()
    want = [(t.action_name, t.state) for t in want.trace]
    for entry in ("run", "run_fused", "paged"):
        _e, res, _g = drive(f"18a_x2_{entry}", lambda cls: stub_device_engine(
            spec=counter_spec(inv_x_bound=2), inv_x_bound=2, device="cuda",
            por="on", cls=cls), entry, True)
        got = [(t.action_name, t.state) for t in res.trace]
        need(res.violated_invariant == "Bound" and got == want,
             f"18a inv_x_bound=2 ({entry}): {got} against the CPU's {want}")
    print(f"  counter_spec(inv_x_bound=2), tile 4, POR on: Bound, the CPU "
          f"run's trace through all three ({len(want)} states)", flush=True)
    for entry in ("run", "run_fused"):
        _e, r_on, _g = drive(f"18a_bound_on_{entry}", lambda cls:
                             stub_device_engine(spec=counter_spec(),
                                                device="cuda", por="on"),
                             entry, False)
        _e, r_off, _g = drive(f"18a_bound_off_{entry}", lambda cls:
                              stub_device_engine(spec=counter_spec(),
                                                 device="cuda", por="off"),
                              entry, False)
        need((r_on.distinct_states, r_on.states_generated, r_on.levels)
             == (r_off.distinct_states, r_off.states_generated,
                 r_off.levels)
             and r_on.metrics["gauges"]["por_cut_ratio"] == 1.0,
             f"18a default Bound ({entry}): POR on is not inert")
        e_on, b_on, _g = drive(f"18a_bounds_on_{entry}", lambda cls:
                               stub_device_engine(
                                   spec=counter_spec(dead_action=True,
                                                     inv_bound=3),
                                   dead_action=True, inv_bound=3,
                                   device="cuda"), entry, False)
        e_off, b_off, _g = drive(f"18a_bounds_off_{entry}", lambda cls:
                                 stub_device_engine(
                                     spec=counter_spec(dead_action=True,
                                                       inv_bound=3),
                                     dead_action=True, inv_bound=3,
                                     device="cuda", bounds="off"),
                                 entry, False)
        tr = lambda r: [(t.action_name, t.state) for t in r.trace]
        need(list(e_on.kern.action_names) == ["IncX", "IncY"]
             and len(e_off.kern.action_names) == 3
             and (b_on.distinct_states, b_on.states_generated, b_on.levels,
                  b_on.violated_invariant, tr(b_on))
             == (b_off.distinct_states, b_off.states_generated,
                 b_off.levels, b_off.violated_invariant, tr(b_off))
             and (e_on._pk.total_bits, e_on._pk_decl.total_bits) == (6, 8),
             f"18a bounds on/off ({entry}): {out[f'18a_bounds_on_{entry}']} "
             f"{out[f'18a_bounds_off_{entry}']}")
    print("  default Bound: POR inert, bit-identical to off (generated "
          "counts included), no K17 launch; bounds on against off "
          "bit-identical (Jump pruned, 6 bits a state against the "
          "declared 8)", flush=True)

    # -- 18b: at scale ---------------------------------------------------
    L = POR["limit"]
    n_full = (L + 1) ** 2
    print(f"phase 18b: the counter (inv_free) at Limit {L}: {n_full} states "
          f"unreduced; tile {POR['tile']}, FPSet {POR['fpset']} slots",
          flush=True)
    scale = {}
    for key, entry, por, Lk in (("fused_off", "run_fused", "off", L),
                                ("fused_on", "run_fused", "on", L),
                                ("run_on", "run", "on", POR["run_limit"])):
        eng, res, got = drive(f"18b_{key}", lambda cls: stub_device_engine(
            spec=counter_spec(inv_free=True, limit=Lk), limit=Lk,
            device="cuda", por=por, tile_size=POR["tile"],
            fpset_capacity=POR["fpset"], next_capacity=POR["next"]),
            entry, por == "on", check_deadlock=True)
        scale[key] = (res, got, Lk)
        o = out[f"18b_{key}"]
        o["limit"] = Lk
        print(f"  {key} (Limit {Lk}): distinct {res.distinct_states} "
              f"generated "
              f"{res.states_generated} levels {len(res.levels)} kept/full "
              f"{o['kept']}/{o['full']} amp {o['amp']} wall "
              f"{o['wall_s']:.3f}s; {res.error} at {res.deadlock_state}; "
              f"K17 {got}", flush=True)
        need(res.error == "deadlock"
             and res.deadlock_state == {"x": Lk, "y": Lk},
             f"18b {key}: {res.error} {res.deadlock_state}")
    need(scale["fused_off"][0].distinct_states == n_full,
         f"18b: POR off gave {scale['fused_off'][0].distinct_states}")
    for key in ("fused_on", "run_on"):
        res, _got, Lk = scale[key]
        need(res.distinct_states == 2 * Lk + 1
             and res.levels == [1] * (2 * Lk + 1),
             f"18b {key}: {res.distinct_states} in {len(res.levels)} levels")
    main_launches = scale["fused_on"][1]

    # -- 18c: K17 against its plain version ------------------------------
    print("phase 18c: K17 against its plain version on the card, bit for "
          "bit, then timed", flush=True)
    rows = []
    for c, label, launches in ((stub_rec.case, "stub", stub_launches),
                               (k17_stress_case(), "stress",
                                main_launches)):
        need(c is not None, "18c: no K17 call was recorded")
        for r in check_k17(c, label):
            r["launches"] = launches[r["kernel"]]
            rows.append(r)

    # -- 18d: the cfg-only bindings --------------------------------------
    for path in (DEFECT, SHIPPED):
        e = DeviceBFS(load_binding(path, "VSR"), device="cuda", por="auto")
        need(e._facts is None and e._por_facts is None
             and not e._por_active and preflight(e.spec).passes_run == [],
             f"18d: {path}: bounds or POR resolved on a cfg-only binding")
    print("phase 18d: the defect and shipped runs (cfg-only bindings) "
          "resolved bounds and POR to None (preflight ran no pass on "
          "them), so phases 5-9 ran as before and held their recorded "
          "numbers", flush=True)
    out["phase_s"] = time.time() - t_phase
    print(f"  phase 18 in {out['phase_s']:.1f}s", flush=True)
    return rows


# ----------------------------------------------------------------------
# phase 19: liveness.  K18 (the state predicates) is held in 19c inside
# phase 9 and in 19d inside phases 10-13; K18_HELD counts the rows each
# instantiation was held on
# ----------------------------------------------------------------------
K18_HELD = {}
# the planes K18's family invariants read (csrc/st03_actions.cu
# St::invariants<MODEL>), where a model has them
K18_FAMILY_PLANES = ("status", "view", "op", "commit", "log", "no_prog",
                     "aux_svc", "aux_acked", "dvc", "dvc_view", "app")
# 19a: the Ticker's five cases (spec, properties, Stop in Next), modulus
# 6, and the JAX harness's graph settings
TICKER_CASES = {
    "FairSpec/AlwaysEventuallyZero": ("FairSpec", ("AlwaysEventuallyZero",),
                                      True),
    "Spec/AlwaysEventuallyZero": ("Spec", ("AlwaysEventuallyZero",), True),
    "FairSpec/EventuallyHit": ("FairSpec", ("EventuallyHit",), True),
    "stop-free FairSpec/EventuallyHit": ("FairSpec", ("EventuallyHit",),
                                         False),
    "stop-free FairSpec/AlwaysEventuallyZero": (
        "FairSpec", ("AlwaysEventuallyZero",), False)}
TICKER_GRAPH = {"tile_size": 4, "chunk_tiles": 2, "next_capacity": 32,
                "fpset_capacity": 1 << 8}
# 19b: A01's streamed CSR held to the two-pass graph out of levels 0-7
A01_PREFIX = 8


def k18_name(kern):
    return getattr(kern, "STATE_PRED_KERNEL", ("vsr_state_pred",))[0]


def k18_cost(kern, n):
    """(bytes, operations) of K18 with every bit on n rows: the words of
    the planes its invariants read, once, and the int32 out (VSR's reads
    only the operation column of the log: R x MAX_OPS words); about
    three operations a compare of the nested loops."""
    span = {k: e - s for k, _sh, s, e in kern.pk._splits}
    R, V, P = kern.R, kern.V, kern.MAX_OPS
    if hasattr(kern, "STATE_PRED_KERNEL"):
        words = sum(span.get(k, 0) for k in K18_FAMILY_PLANES)
        ops = 3 * (3 * R * R * P + R ** 3 + 2 * V * R * P + 6 * R * R)
    else:
        words = sum(span[k] for k in ("status", "view", "aux_acked")) \
            + R * P
        ops = 3 * (2 * V * R * P + 2 * R)
    return n * (words + 1) * 4, n * ops


def check_k18_succ(kern, flat, pidx, aid, lane, what):
    """19d: K18 with every bit on the successor rows of a recorded K14
    (or K10) queue, bit for bit against K14's iok under each invariant
    alone and against K18's plain version."""
    import torch
    names = list(kern.INVARIANT_FNS)
    full = (1 << len(names)) - 1
    ioks = [kern.successors(flat, pidx, aid, lane, 1 << b)["iok"]
            for b in range(len(names))]
    succ = kern.successors(flat, pidx, aid, lane, 0)["succ"]
    bits = kern.state_predicates(succ, full)
    need(torch.equal(bits, kern.state_predicates_plain(succ, full)),
         f"{what}: {k18_name(kern)} differs from its plain version")
    for b, (n, iok) in enumerate(zip(names, ioks)):
        need(torch.equal((bits >> b & 1).bool(), iok),
             f"{what}: {k18_name(kern)}'s {n} bit differs from "
             f"{getattr(kern, 'ACTIONS_KERNEL', ('vsr_actions',))[0]}'s "
             f"iok")
    K18_HELD[k18_name(kern)] = K18_HELD.get(k18_name(kern), 0) \
        + succ.shape[0]


def k18_over_blocks(eng, what, batch=1 << 16):
    """19b, 19c: K18 with every bit over the retained level blocks of
    ``eng`` (flat rows on the card, ``batch`` rows at a time, as
    ``DeviceGraph._run_batched`` moves them), bit for bit against its
    plain version on the same rows.  Returns (rows, the rows on which
    each INVARIANT_FNS entry holds, the largest batch)."""
    import numpy as np
    import torch
    kern = eng.kern
    names = list(kern.INVARIANT_FNS)
    full = (1 << len(names)) - 1
    holds, n, big = np.zeros(len(names), np.int64), 0, None
    for blk in eng.level_blocks:
        nb = next(iter(blk.values())).shape[0]
        for lo in range(0, nb, batch):
            flat = eng._pk.flatten({
                k: torch.as_tensor(v[lo:lo + batch], device="cuda")
                for k, v in blk.items()}).contiguous()
            a = kern.state_predicates(flat, full)
            p = kern.state_predicates_plain(flat, full)
            need(torch.equal(a, p), f"{what}: {k18_name(kern)} differs "
                 f"from its plain version on {int((a != p).sum())} of "
                 f"{flat.shape[0]} rows")
            holds += torch.stack([(a >> b & 1).sum() for b in
                                  range(len(names))]).cpu().numpy()
            n += flat.shape[0]
            if big is None or flat.shape[0] > big.shape[0]:
                big = flat
    K18_HELD[k18_name(kern)] = K18_HELD.get(k18_name(kern), 0) + n
    return n, dict(zip(names, holds.tolist())), big


def k18_row(out, kern, flat, launches, label):
    """A kernels-line row of K18 (every bit) on ``flat``, timed after an
    L2 flush, with its plain version's time and its byte bound."""
    names = list(kern.INVARIANT_FNS)
    full = (1 << len(names)) - 1
    n = flat.shape[0]
    nbytes, nops = k18_cost(kern, n)
    name = k18_name(kern)
    kernel_row(out, name,
               cuda_ms(lambda: kern.state_predicates(flat, full),
                       evict=l2_evict(flat.device)),
               cuda_ms(lambda: kern.state_predicates_plain(flat, full),
                       reps=5),
               max_abs(kern.state_predicates(flat, full),
                       kern.state_predicates_plain(flat, full)),
               nbytes, nops,
               extra={"shape": [n, kern.pk.lanes], "bits": len(names)},
               label=label)
    out[-1]["launches"] = launches


def liveness_phase(args, doc):
    """Phase 19: liveness on the card (19a, 19b; 19c ran in phase 9 and
    19d in phases 10-13).  Returns A01's K18 row."""
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_liveness import (DeviceGraph,
                                                     two_pass_prefix)
    from tpuvsr_torch.engine.liveness import liveness_check
    from tpuvsr_torch.engine.paged_bfs import PagedBFS
    from tpuvsr_torch.testing import (canon_csr, stub_ticker_factory,
                                      ticker_spec)
    t_phase = time.time()
    out = doc["liveness"] = {}

    def verdict(res):
        return (res.ok, res.property_name,
                [(e.action_name, dict(e.state)) for e in res.trace],
                res.cycle_start, res.distinct_states)

    print("phase 19a: the Ticker's liveness verdicts through DeviceGraph "
          "on the card, stream and two-pass, against the interpreter's "
          "graph", flush=True)
    for case, (name, props, stop) in TICKER_CASES.items():
        spec = ticker_spec(spec_name=name, props=props, modulus=6,
                           stop=stop)
        want = verdict(liveness_check(spec))
        for mode in ("stream", "two-pass"):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.time()
            g = DeviceGraph(spec, mode=mode, device="cuda",
                            model_factory=stub_ticker_factory(6, stop),
                            **TICKER_GRAPH)
            got = verdict(liveness_check(spec, graph=g))
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = kernels.launch_counts()
            k = "edge_emit" if mode == "stream" else "fpset_probe"
            need(counts[k] > 0, f"19a {case} {mode}: {k} not launched")
            need(got == want, f"19a {case} {mode}: {got[:2]} lasso "
                 f"{got[2]} from {got[3]}; the interpreter's {want[:2]} "
                 f"{want[2]} from {want[3]}")
            out[f"19a {case} {mode}"] = {"ok": got[0], "property": got[1],
                                         "lasso": len(got[2]),
                                         "cycle_start": got[3],
                                         "wall_s": wall}
        print(f"  {case}: ok {want[0]} {want[1] or ''} lasso of "
              f"{len(want[2])} states from {want[3]}: stream and two-pass "
              f"equal the interpreter's", flush=True)
    need([v["ok"] for k, v in out.items() if k.startswith("19a")] ==
         [False] * 6 + [True] * 4, "19a: verdicts")

    fam = FAMILY["A01"]
    print("phase 19b: A01's small cfg through PagedBFS(retain_levels, "
          "edges) to its fixpoint, the graph handed over, K18 over every "
          "state", flush=True)
    eng, res, info = model_run("A01", fam["module"], "small", "run",
                               engine_cls=PagedBFS, retain_levels=True,
                               edges=True, label="A01 small (19b, edges)")
    for k in ("fpset_store_gids", "fpset_probe", "edge_emit",
              "a01_state_pred"):
        need(info["launches"][k] > 0, f"19b: {k} was not launched")
    need((res.distinct_states, res.states_generated, res.diameter)
         == fam["fixpoint"] and res.levels == fam["small"],
         f"19b: {res.distinct_states} / {res.states_generated} / "
         f"{res.diameter}, levels {res.levels}")
    t0 = time.time()
    g = DeviceGraph(eng.spec, engine=eng, result=res)
    graph_s = time.time() - t0
    need(g.mode == "stream" and g.n == fam["fixpoint"][0],
         f"19b: graph {g.mode} of {g.n} states")
    upto = sum(fam["small"][:A01_PREFIX])
    t0 = time.time()
    tp = two_pass_prefix(eng, A01_PREFIX)
    two_s = time.time() - t0
    cs, ct = canon_csr(g), canon_csr(tp)
    need(ct[:upto] == cs[:upto] and not any(ct[upto:]),
         f"19b: the two-pass graph out of levels 0-{A01_PREFIX - 1} "
         f"differs from the streamed one")
    names = list(eng.kern.INVARIANT_FNS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    vals = {n: g.batch_predicate(n) for n in names}
    torch.cuda.synchronize()
    pred_s = time.time() - t0
    counts = kernels.launch_counts()
    launches = counts["a01_state_pred"]
    need(launches == len(names) * len(g.blocks), f"19b: {launches} K18 "
         f"launches for {len(names)} predicates over {len(g.blocks)} "
         f"level blocks")
    n, holds, _big = k18_over_blocks(eng, "19b")
    need(n == g.n, f"19b: {n} rows held")
    for n_, v in vals.items():
        need(int(v.sum()) == holds[n_], f"19b: batch_predicate({n_}) "
             f"holds on {int(v.sum())} states, K18 on {holds[n_]}")
    need(holds["AllReplicasMoveToSameView"] < g.n,
         "19b: AllReplicasMoveToSameView holds on every state")
    out["19b"] = {"distinct": g.n, "edges": int(g.csr[1].shape[0]),
                  "edges_per_s": g.edges_per_s, "graph_s": graph_s,
                  "two_pass_s": two_s, "predicates_s": pred_s,
                  "holds": holds, "bfs_wall_s": info["wall_s"]}
    print(f"  {g.n} states, {int(g.csr[1].shape[0])} edges; the two-pass "
          f"graph out of levels 0-{A01_PREFIX - 1} ({upto} sources) equals "
          f"the streamed one; batch_predicate over {g.n} states in "
          f"{pred_s:.3f}s ({launches} K18 launches)", flush=True)
    print(f"  states where each predicate holds: {holds}", flush=True)
    # the fixpoint's shape: every state in one call
    every = torch.cat([g._flat(b, 0, next(iter(b.values())).shape[0])
                       for b in g.blocks]).contiguous()
    rows = []
    k18_row(rows, eng.kern, every, launches,
            "a01_state_pred (19b, A01's fixpoint)")
    del every
    del g, tp, eng

    print("phase 19c/19d: K18 held on every model", flush=True)
    want = ["vsr_state_pred"] + [f"{m.lower()}_state_pred" for m in (
        "ST03", "A01", "I01", "AS04", "RR05", "AL05", "CP06")]
    need(all(K18_HELD.get(k, 0) > 0 for k in want),
         f"K18 held on {K18_HELD}")
    out["k18_held_rows"] = dict(K18_HELD)
    print(f"  rows held bit for bit: {K18_HELD}", flush=True)
    out["phase_s"] = time.time() - t_phase
    print(f"  phase 19 in {out['phase_s']:.1f}s", flush=True)
    return rows


def gpu_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the measurements to this JSON file")
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tpuvsr_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(tpuvsr_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    doc = {}
    t_all = time.time()
    try:
        return run_phases(args, doc, t_all)
    except SmokeError as e:
        doc["failed"] = str(e)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=1, default=str)
        raise


def write_doc(args, doc):
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, default=str)


def kernels_line(rows):
    return json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        | ({"timed_by": r["timed_by"]} if "timed_by" in r else {})
        for r in rows]})


def run_phases(args, doc, t_all):
    """Phases 1-19 (the module docstring); returns the exit code."""
    import numpy as np
    import torch
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.device_bfs import DeviceBFS, device_bfs_check
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.testing import (STUB_DISTINCT, STUB_LEVELS,
                                      stub_device_engine)

    print("phase 1: build", flush=True)
    t0 = time.time()
    took = kernels.build()
    doc["build_s"] = time.time() - t0
    print(f"  built {sorted(took)} in {doc['build_s']:.1f}s", flush=True)

    print("phase 2: card", flush=True)
    card = gpu_line()
    print(card, flush=True)
    doc["card"] = card
    doc["device_name"] = torch.cuda.get_device_name(0)

    print("phase 3: kernels against their plain versions", flush=True)
    binding = load_binding(DEFECT, "VSR")
    rec = Recorder()
    uninstall = rec.install()
    eng = DeviceBFS(binding, tile_size=128, chunk_tiles=64,
                    fpset_capacity=1 << 26, device="cuda")
    t0 = time.time()
    warm = eng.run(max_depth=args.depth)
    uninstall()
    doc["record_s"] = time.time() - t0
    need(warm.levels == LEVELS[:args.depth + 1],
         f"recording run levels {warm.levels}")
    doc["recorded_sizes"] = {k: v[0] for k, v in rec.calls.items()}
    rows = check_kernels(rec)
    del rec, eng

    print("phase 4: counter stub", flush=True)
    r = stub_device_engine(device="cuda").run()
    need(r.ok and r.distinct_states == STUB_DISTINCT
         and r.levels == STUB_LEVELS, f"stub run: {r.distinct_states} "
         f"{r.levels}")
    r = stub_device_engine(device="cuda", inv_bound=4).run()
    need(not r.ok and r.violated_invariant == "Bound"
         and [(t.action_name, t.state) for t in r.trace] == STUB_TRACE,
         f"stub violation trace: {[(t.action_name, t.state) for t in r.trace]}")
    print(f"  stub: 16 distinct, levels {STUB_LEVELS}, Bound trace ok",
          flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            device_bfs_check(binding, max_depth=7, fpset_capacity=1 << 20,
                             device="cuda")
            torch.cuda.synchronize()
            wall7 = time.time() - t0
        ka = prof.key_averages()
        dev_us = device_us(prof)
        doc["profile_depth7"] = {
            "wall_s": wall7, "device_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / wall7,
            "table": ka.table(sort_by="cuda_time_total", row_limit=40)}
        print(f"  profiled depth 7: wall {wall7:.3f}s, device busy "
              f"{dev_us / 1e6:.3f}s", flush=True)

    print(f"phase 5: BFS path, defect config to depth {args.depth}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    plain0 = plain_calls()
    t0 = time.time()
    eng = DeviceBFS(binding, tile_size=128, chunk_tiles=64,
                    fpset_capacity=1 << 26, device="cuda")
    res = eng.run(max_depth=args.depth)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    k10_only(counts, plain0, "the BFS path")
    run_pointers = [np.concatenate(getattr(eng, k))
                    for k in ("_h_parent", "_h_action", "_h_param")]
    doc["main_pointers"] = run_pointers
    del eng
    need(res.ok, f"main path: {res.violated_invariant} {res.error}")
    need(res.levels == LEVELS[:args.depth + 1],
         f"main path levels {res.levels}")
    need(res.distinct_states == sum(LEVELS[:args.depth + 1]),
         f"main path distinct {res.distinct_states}")
    main = {"depth": args.depth, "levels": res.levels,
            "distinct": res.distinct_states,
            "generated": res.states_generated, "wall_s": wall,
            "distinct_per_s": res.distinct_states / wall,
            "generated_per_s": res.states_generated / wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts, "metrics": res.metrics}
    doc["main"] = main
    print(f"  levels {res.levels}", flush=True)
    print(f"  distinct {res.distinct_states} generated "
          f"{res.states_generated} wall {wall:.3f}s distinct/s "
          f"{main['distinct_per_s']:.1f} generated/s "
          f"{main['generated_per_s']:.1f} max_memory_allocated "
          f"{main['max_memory_allocated']}", flush=True)
    print(f"  launches {counts}", flush=True)
    for k in rows:
        k["launches"] = counts[k["kernel"]]
        need(k["launches"] > 0, f"{k['name']} was not launched on the "
             f"BFS path")
    need(counts["vsr_canon"] == 0, "K9 was launched on the BFS path")
    need(counts["vsr_state_pred"] > 0, "K18 was not launched on the BFS "
         "path (the initial states' invariants)")
    rows += hunt_phase(args, doc)
    rows += fused_phase(args, doc, binding, run_pointers)
    rows += symmetric_phase(args, doc)
    rows += paged_phase(args, doc, binding, run_pointers)
    rows += st03_phase(args, doc)
    rows += family_phase(args, doc)
    rows += recovery_phase(args, doc)
    rows += checkpoint_phase(args, doc)
    rows += family_symmetry_phase(args, doc)
    rows += per_action_phase(args, doc)
    rows += sim_phase(args, doc)
    rows += validate_phase(args, doc)
    rows += por_phase(args, doc)
    rows += liveness_phase(args, doc)
    doc.pop("main_pointers", None)
    doc["kernels"] = rows
    doc["total_s"] = time.time() - t_all
    write_doc(args, doc)
    print(kernels_line(rows))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
