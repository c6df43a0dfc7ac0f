#!/usr/bin/env python3
"""Smoke run of corda_tpu_torch's verification paths on one CUDA card.

    python3 chip_smoke.py [--out PATH] [--lane-dir DIR]

Phases (any failure raises and exits non-zero). Phases 1, 2, 3's
timing and 4 run first, in this process alone. Then the phases run in
five processes at once on the one card (QUIET, HOME and LANES below
main): here 3's parity, 5, 6, 8 and 14; in four lanes (this script with
`--lane`, each printing what it prints into a file, relayed after this
process's own lines) 11, 13, 15 and 7; 16 and 10; 12, 17 and 9; 18 and 19. A lane
without phase 6 builds the same fixture itself. The parts that count
the card's CUDA contexts (11c, 11d, 12a, 18c) hold a lock that no other part
starting or stopping a card process holds meanwhile, and every lane
keeps its context until all have finished. Walls and rates of phases
3's parity and 5-19 are taken beside the other processes:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from corda_tpu_torch/csrc with nvcc (one
     process per source, all started together: the ladders,
     wei_ladder.cu and ed_ladder.cu, and the verify programs around
     them, ed_ends.cu and wei_ends.cu) and, beside them, the
     native host library (corda_tpu_torch/native/cts_hash.cpp: the CTS
     codec, SHA-256, Merkle trees, the staging sweeps and the asset
     sweep) with g++; print the compiler, the seconds the build took and
     whether the CPU takes the SHA-NI path;
  3. print each kernel's registers, stack, static shared memory and
     resident warps per SM (CUDA runtime); hold each ladder kernel
     against its plain torch version on the card — the Weierstrass
     ladders on p256 and secp256k1, the Edwards ladders on ed25519,
     each at B=256 and at the ragged B=130 and B=1 (partial groups and
     warps; edge rows u1=0, u2=0, Q=G and u2=n-u1 with Q=G; s=0, k=0,
     A=identity, s=L, s+L, all-264-bit scalars, A of order 2 and 4;
     one plain call at B=256 per kernel and curve, the smaller batches
     held against its first rows, as the plain version is row by row):
     equal normalised points, X*Y == Z*T for the Edwards outputs, and
     the first 8 rows equal to refmath; hold each prologue and epilogue
     kernel (ed_prologue, ed_epilogue; ecdsa_prologue, ecdsa_epilogue on
     p256 and secp256k1; each a row per group of 4 lanes) against its
     plain torch version at B=256, 130, 1, 3 and 4097 (a partial and a
     ragged lane group) over testing/selfcheck.py's rows, the crafted
     edge rows first
     (A.y = 0, 1, p - 1, >= p, off the curve, each sign bit; z >= n, r
     and s 0, n, 2^256 - 1, Q off the curve or >= p, the r + n row; for
     the epilogues R.y + p, a flipped sign, r + n >= p, Z = 0):
     verdicts and scalar digits exact, points equal mod p; time each
     ladder kernel and its plain version at the main path's chunk (4096,
     main-path scalars) and hold them equal there too;
  4. time each prologue and epilogue kernel (CUDA events, and its device
     time per launch from torch.profiler) and its plain
     version at 4096 rows, held equal there, with its IMAD bound
     (_ends_ops, the curve's cost per multiply; ENDS_BYTES); then one 4096-row
     ed25519_verify_packed and ecdsa_verify_packed per curve on the
     card: its time and its torch ops, which must be under 100 (a
     handful of allocations beside the three launches);
  5. the main path through CudaBatchVerifier(batch_sizes=(128, 1024,
     4096)).verify_batch_async(...).chunks(): a 16,384-row p256 flush,
     a 4,096-row secp256k1 batch, a 16,384-row ed25519 flush, a
     4,096-row ed25519 batch with windowed=True, and a 16,384-row mixed
     call (even thirds ed25519 / secp256k1 / p256). Each is built from
     256 distinct signed requests per scheme with tampered rows (and
     the ed25519 edge rows), tiled; every row must equal the CPU
     reference of its distinct request. The launch counters are set to 0
     just before each path and read just after; each path must have
     launched its kernels: its ladder and its schemes' prologue and
     epilogue;
  6. the batching notary (corda_tpu_torch.node.notary) over
     CudaBatchVerifier(batch_sizes=(4096,)): a 16,384-spend flush of
     single-input Cash spends (testing/notary_fixture.py: 3 in 4
     signers ed25519, 1 in 4 p256; 1 in 64 a flipped signature byte, 1
     in 64 a double spend of the spend before it, 1 in 256 naming
     another notary), through the service flow's entry (`process`) and
     one `flush()`, for shards = 1 and 4 (ShardedUniquenessProvider), a
     warm-up pass then a timed one, each with a fresh uniqueness
     provider, degraded_fallback=False, and a fresh decode of the
     spends' wire bytes (outside the timed window, so each pass pays the
     transaction ids and Merkle roots itself). Every pass must answer each
     spend as its label (the first spend of each double-spend pair
     wins; the accepted count exact), the card's verdicts must equal
     CpuBatchVerifier on 256 sampled rows (and reject exactly the
     flipped ones), 8 notary signatures must verify against their
     Merkle proofs, ed_ladder and wei_ladder_windowed must have
     launched, and the notary must not have degraded. Prints
     notarisations/s, the decode and flush walls, phase_seconds, host staging and
     device seconds of the notary's dispatches and the launches. Before
     the passes, outside their windows, every spend's wire bytes are
     encoded again by the native and the Python codec, and decoded by
     each: equal bytes, equal transaction ids (native tree against the
     Python tree over Python encodings) and equal Merkle roots over the
     ids, or the script raises; the per-spend times of both are printed;
  7. every scheme and attachment code: a flush of the first 64 phase-6
     spends plus spends with an added RSA-2048 signature (one flipped),
     an added SPHINCS-256 signature (one flipped) and outputs under a
     contract that travels only as an attachment (one spend satisfies it,
     one breaks it) — RSA and SPHINCS rows verified on the host in the
     same dispatch, the contract run in the sandbox. Every answer must
     equal its label (the reference's answer, held by
     tests/test_torch_chip_smoke.py on the CPU), the verdicts equal
     CpuBatchVerifier, ed_ladder and wei_ladder_windowed launch, and no
     flush degrades; prints host_rows and host_seconds;
  8. the flows, the in-memory fabric and MockNetwork over
     CudaBatchVerifier(batch_sizes=(128, 4096)) on the card: (a) drive
     1 with a validating notary — Bank issues to Alice (ed25519), Alice
     pays Bob (p256), Bob pays Carol (secp256k1) and Carol pays Bank,
     each recipient resolving the backchain through the card; a payment
     interrupted while it awaits the notary restores from its checkpoint
     in a fresh state machine and completes; a spend with a flipped
     signature byte is refused by FinalityFlow (InvalidSignature) and by
     the notary ("invalid-transaction"); a double spend raises
     NotaryException "conflict"; every balance exact; (b) a batching
     notary for shards 1 and 4: 2 payments from 2 payers (issuance
     recorded straight into the vaults) started before one pump round
     and notarised in one flush (one dispatch per shard holding
     requests), every payment completed and every balance exact, no
     degraded flush, answers spread over the shards; (c) (a) again over
     CpuBatchVerifier: the same transaction ids, notary signatures,
     refusals and balances. ed_ladder, wei_ladder_windowed and wei_ladder
     must launch within (a) and (b). Prints flows/s, card verify calls per
     payment and rows per call, their summed chunk-event seconds, the
     notary flush's rows and walls, and the phase's wall;
  9. the out-of-process verifier pool and the pipelined wire ingest
     (node/verifier.py, node/ingest.py) on the phase-6 fixture, over
     one CudaBatchVerifier(batch_sizes=(4096,)) that two VerifierWorkers
     share (batch_window 8,192): (a) the first 4,096 spends sent with
     `verify(ltx, stx)` from a node endpoint of an
     InMemoryMessagingNetwork, each ltx resolved on the fixture's hub;
     each worker answers its 2,048 in one drain and one verify_batch
     dispatch (Verifier.BatchSize); every answer must be its label (an
     InvalidSignature failure exactly for the flipped signatures,
     success for the rest: the worker checks no uniqueness or notary),
     256 sampled answers must equal a CpuBatchVerifier worker's, and
     ed_ladder and wei_ladder_windowed must launch in the drains;
     prints verified transactions/s from the first verify to the last
     answer, each drain's decode / dispatch / contract / answer seconds
     and the frame bytes per request; (b) the same through
     request_ingest_pipeline(shards=4): answers equal to (a)'s, with
     the pipeline's stage seconds and frame-cache hits, then the
     ingest's Merkle-id stage timed on fresh decodes of every spend
     with its caches, without them and against the native id walk,
     ids held equal, with the garbage collection inside each run (and
     inside each pass of 9a, 9b and 9d); (c) 256
     requests, one worker lost with its half received and unanswered:
     on a TestClock its lease expires, its nonces re-dispatch and every
     future is answered exactly once, by the survivor on the card
     (Verifier.Redispatched > 0); (d) the batching notary fed from its
     ingest ring: an IngestPipeline feeds the wire bytes of every spend
     naming this notary from its thread into attach_ingest (the ring
     path checks no notary; the spends naming another go through
     `process`), one flush, every answer its phase-6 label under
     phase 6's checks;
 10. persistence and the notary clusters (node/persistence.py,
     node/raft.py, node/bft.py, MockNetwork's db_dir, restart_node and
     cluster factories) over CudaBatchVerifier, the launch counters set
     to 0 before 10a and read after 10e: (a) the first 4,096 phase-6
     spends in one flush through BatchingNotaryService over an on-disk uniqueness
     store (PersistentUniquenessProvider for 1 shard,
     ShardedPersistentUniquenessProvider for 4), one pass each on a
     fresh database and a fresh decode, held to phase 6's checks; the
     database closed and reopened under a new provider and notary, its
     committed inputs read back, and 256 new spends of accepted
     spends' inputs answered "conflict", each naming the committed
     spend; prints notarisations/s, the flush wall, phase_seconds and
     the seconds in sqlite; (b) a validating Raft cluster of 3 persistent
     members on MockNetwork(db_dir=) over CudaBatchVerifier(batch_sizes=
     (128, 4096)): an issue, three payments (two resolving a backchain)
     from ed25519, p256 and secp256k1 nodes, a double spend refused
     "conflict" with every member's map holding the first spend, the
     leader stopped and a payment under the new leader, the live maps
     equal, the ledger (ids, cluster signatures, refusals, leaders,
     balances) equal to the same drive over CpuBatchVerifier; prints
     flows/s, card verify calls per flow and rows per call; (c) 4,096
     distinct single-input commits through the new leader's
     RaftUniquenessProvider, one per pump round (4 snapshots at the
     interval of 1,024), then the stopped member rebuilt with
     rebuild_cluster_member: restored by InstallSnapshot chunks and a
     log replay, its map equal to the leader's; prints the seconds of
     the commits and of the transfer and the snapshot bytes; (d) a BFT
     cluster of 4 (f = 1) on the same network: an issue, payments whose
     answers carry a composite-key (threshold 2) signature, a double
     spend refused "conflict", a replica that is not the primary
     stopped (a payment commits), rebuilt (it catches up by state
     transfer), then the primary stopped (the view change; a payment
     commits), the live maps equal; (e) a persistent validating notary,
     an ed25519 bank and a p256 payer: the payer restarted with
     restart_node mid-payment (its vault page equal before and after and
     to an in-memory network's run of the same drive; the checkpointed
     payment finishes), then the notary restarted (a double spend of a
     state it committed before is refused "conflict"). ed_ladder,
     wei_ladder_windowed and wei_ladder must launch;
 11. real sockets on 127.0.0.1 (node/fabric.py, node/config.py,
     node/node.py, node/network_map.py, node/rpc.py, utils/health.py,
     the node CLI and the verifier worker process), every node with
     verifier_backend = "tpu" (in this process, default_verifier(): a
     CudaBatchVerifier(batch_sizes=(128, 4096)) on the card; in a
     subprocess, its own CudaBatchVerifier) and TLS with fingerprint
     pinning (a fresh identity where `cryptography` imports, else the
     committed testing/dev_tls.pem; the source is printed), the launch
     counters set to 0 before 11a and read after 11b: (a) Hub (map host,
     batching notary of 1 shard over PersistentUniquenessProvider, a
     300 ms batch wait), Alice (ed25519), Bob (p256) and Carol
     (secp256k1): discovery through the map, an issue, payments across
     the schemes (Carol resolving a backchain), a payment each from
     Alice and Bob started together (the notary flushes answering them
     printed), a flipped signature refused at finality and by the
     notary, a double spend refused "conflict", Bob stopped and booted
     again from his base_dir (his vault page equal, a payment to him
     settled); the same drive over verifier_backend = "cpu" nodes (in a
     process of its own, beside the card's drive) must leave the same
     transaction ids, refusals, balances, consumed refs and notary
     commits; prints flows/s, card calls per flow, rows per
     call and each node's fabric frames, bytes and journal depths; (b)
     a raft-validating cluster of 3 and a bft cluster of 4 (f = 1), each
     with a map host and Alice: an issue, a spend, a double spend
     refused "conflict"; for Raft the leader stopped, the survivors
     elect and a payment settles. ed_ladder, wei_ladder_windowed and
     wei_ladder must launch within (a) and (b); (c) two `python -m
     corda_tpu_torch.node --config <toml> --print-port` processes (a
     validating notary hosting the map, and a client): over RPCClient
     from a console endpoint here, CashIssueFlow from the notary to the
     second node, a CashPaymentFlow from it back to the notary, and both
     vaults queried; the node processes must
     hold a CUDA context each (the card's contexts in nvidia-smi
     --query-compute-apps rise by one per process: in a container the
     pids it prints are not the processes' own) and SIGTERM must
     end each with exit code 0 within 15 s; (d) a node with
     verifier_type = "out_of_process" (TLS off, as the reference's
     worker dials by address) and two `python -m
     corda_tpu_torch.node.verifier` processes (batch window 256): a
     warm-up request each, after which each worker must hold a CUDA
     context (counted as in (c)); worker 0 frozen (SIGSTOP) so that it
     holds its share unanswered; the first 2,048 phase-6 spends as
     `verify(ltx, stx)` requests through the durable journals; once a
     quarter is answered worker 0 gets SIGKILL; its unanswered nonces
     re-dispatch to the survivor when its lease expires. Every answer
     must be its label, every future answered once and only worker 0
     lost (the pool's attempt and request deadlines and its lease are
     set past the burst); prints the survivor's longest silence at the
     node beside the lease,
     verified transactions/s, the seconds to deliver the frames
     through the journals against the seconds to answer them, gc
     seconds and the survivor's drains;
 12. the multi-process Driver, the load test, the ledger fuzzer and the
     demos (testing/driver.py, testing/loadtest.py,
     testing/generators.py, samples/): (a) the Driver's default backend
     (the card, in each node process) boots Hub (map host, batching
     notary, a 50 ms batch wait), Alice (ed25519), Bob (p256) and Carol
     (secp256k1) as `python -m corda_tpu_torch.node` processes;
     CrossCashLoadTest(seed=31) runs 12 commands in a tight loop, a
     traffic node killed (-9) and restarted at 0.35 and the notary at
     0.65; no command may fail, the model must reconcile, every traffic
     node's vault total over RPC must equal the model, and the card must
     hold a new CUDA context per node while the commands run; then 50
     empty flows on Alice (EmptyFlowLoadTest); prints each node's boot
     seconds, the restarts' seconds, commands/s, p50 and max per-command
     latency and empty flows/s; the children's launches go uncounted.
     The launch counters set to 0 before 12b and read after 12d: (b)
     samples/notary_demo.run on its default verifier (the card),
     "batching" with 2 payments (sharing flushes) and "single" with 1:
     one notary signature per transaction, and the same transaction ids
     and signer keys as the same run over CpuBatchVerifier; prints tx/s;
     (c) the reference's fuzz corpus (GeneratedLedger(13).grow(30),
     mutated: flipped, tampered, truncated rows) and the same mutation
     over GeneratedLedger(17).grow(500), all three schemes, through
     CudaBatchVerifier(batch_sizes=(128, 1024, 4096)): every verdict must
     equal its label, and CpuBatchVerifier's on the small corpus and 256
     sampled rows of the large one; (d) samples/trader_demo.run on the
     card: one paper to the buyer, 92,000 to the seller. ed_ladder,
     wei_ladder_windowed and wei_ladder must launch within (b)-(d);
 13. the perf, device and wire planes (utils/perf.py,
     utils/device_telemetry.py, utils/wire_telemetry.py) over the first
     4,096 phase-6 spends, their wire bytes delivered over an in-memory
     fabric to a batching notary over CudaBatchVerifier(batch_sizes=
     (4096,)), with fresh process kernel and device ledgers and a
     HealthMonitor watching the three planes: (a) two flushes, every
     answer its label under phase 6's checks: one compile per (scheme,
     batch) key on the first, executes only and 0 retraces after
     mark_warm() on the second; the card's device row (platform "gpu",
     its name, its total memory as the limit, live buffers counting a
     1 MiB tensor the phase holds on the card), the
     device ledger of cuda:0 (busy seconds, dispatches, queue wait,
     transfer bytes and seconds), the plane's busy fraction, the
     capacity model's binding constraint with every headroom fraction,
     the alerts and the wire totals; (b) one torch.profiler window (CPU
     and CUDA) over one warm ed25519 chunk of that flush: summed kernel
     time, the ladder kernel's share of it and the card's busy share of
     the window, beside the device plane's busy fraction (the launch
     wall) for the same window; (c) the flush with the planes on and
     off, 2 interleaved pairs, the min-of-walls overhead (not gated);
     (d) a `python -m corda_tpu_torch.node.verifier --profile-hz 19
     --profile-out <file>` process draining 256 requests for a node's
     pool, every answer its label, SIGINT exit 0 and a non-empty
     folded-stack file. ed_ladder and wei_ladder_windowed must launch
     in (a)-(c);
 14. the notary's serving-path planes (node/qos.py, utils/txstory.py,
     persistence.NotaryIntentJournal and TxStoryIndex,
     node/statestore.py) over the phase-6 fixture and
     CudaBatchVerifier(batch_sizes=(4096,)), degraded_fallback=False,
     the launch counters set to 0 before 14a and read after 14d: (a)
     the first 4,096 spends through `process` into a 1-shard batching
     notary with NotaryQos (a p99 target of 10 s, batch up to 4,096, a
     wait up to 300 ms, a 64-token bucket refilled at 50/s per
     requester) and a TxStory: 1 spend in 32 arrives with its deadline
     already past, 1 in 16 comes from one requester over its bucket, the
     rest from 240 requesters inside theirs (no shed ever opens a
     double-spend pair); every spend answered once, as its label or
     `shed` (ExpiredIngress, ExpiredFlush, Admission or a brownout
     reason), the Qos counters equal to the answers, every admitted
     answer equal to a notary's without QoS over the same admitted
     spends, and the story's lifecycle check (one story per spend past
     the notary check, each closed by exactly one terminal that agrees
     with its answer and shed reason; none open, none evicted); prints
     the controller's batch and wait after each flush, the admitted
     p99, the sheds by reason, the brownout transitions and
     notarisations/s, then one flush of 4,096 with the planes on and
     one with them off (no gate); (b) QosPolicy() over 256 spends in 4
     arrival rounds, the same readings after each flush and the same
     reconciliation; (c) a NodeDatabase, a
     ShardedCommitLogUniquenessProvider of 4 partitions and a
     NotaryIntentJournal under a 4-shard notary: 2,048 spends admitted,
     the notary killed before its flush (the database closed without
     the buffered deletes), the database and store reopened and
     `replay_intents` flushed once on the card, every journaled spend
     answered exactly once as its label; killed again before the
     deletes and replayed again (the same-transaction re-commit absorbs
     the committed), the same answers; the committed map equal to a
     PersistentUniquenessProvider's over the same spends (which accepts
     the same re-commit), and unchanged by compaction, a reopen and
     `migrate_sqlite_state` into a fresh store; (d) a Node from
     node.toml, provisioned with the fixture's notary key, with every
     plane (batching, qos_enabled, notary_intent_wal, the commit-log
     store, txstory_enabled, txstory_index): unported_planes == (),
     256 spends through its notary, every answer its label, and after a
     pump tick each admitted spend's story with its terminal in the
     TxStoryIndex, the QoS and txstory rules on the health monitor, the
     WAL drained and the commit log holding the accepted spends'
     inputs. ed_ladder and wei_ladder_windowed must launch; prints each
     part's wall and the phase's;
 15. distributed uniqueness across notary cluster members
     (node/distributed_uniqueness.py, its journals in
     node/persistence.py, testing/sanitizer.py) over the phase-6 fixture
     and one CudaBatchVerifier(batch_sizes=(4096,)), degraded_fallback=
     False, the launch counters set to 0 before 15a and read after 15c:
     (a) three BatchingNotaryService members over
     DistributedUniquenessProviders (6 partitions, two per member) on
     one in-memory fabric and TestClock, each member's committed rows,
     coordinator WAL, reservation journal and intent WAL in its own
     sqlite database, all three dispatching to the one verifier: the
     first 2,048 spends round robin over the members (about two in three
     coordinated away from their input's owner), one flush per member,
     then fabric rounds to quiescence. Every answer must equal a single
     batching notary's over PersistentUniquenessProvider on the same
     spends (itself equal to the labels), but that either rival of a
     double spend may win; each input committed at its owner only, to at
     most one spend, every accepted spend's input to it; the shared
     decision log replayed serially over one map makes every logged
     decision and ends at the merged committed map; no reservation,
     orphan, in-flight transaction or WAL row is left; the member
     flushes make at least one card call each. Prints notarisations/s
     (first `process` to last answer) and those card calls; the single
     notary's launches are counted apart, before 15a-15c's; (b) faults: the third member partitioned away
     past the reserve timeout (1 s of TestClock) while 96 later "ok"
     spends are served round robin: exactly the spends across the
     partition answer `shard-unavailable`, `shard.unreachable` fires on
     the first member's HealthMonitor; after the heal the retries sign
     and the alert resolves; then 64 "ok" spends at the first member
     owned elsewhere, decided (the WAL's commit marks durable, every
     answer signed), their ShardCommits lost with the kill (dropped on
     the wire: no owner holds a row); the member built again over its
     database, and `recover()` re-drives all 64 until every owner holds
     the rows; (c) an armed
     ConcurrencySanitizer over testing/sanitizer.standard_soak (a
     4-shard batching notary with worker threads and a concurrent
     reader) on the same verifier: no lock-order inversion and no
     self-deadlock; prints the five most contended locks with their
     hold times. ed_ladder and wei_ladder_windowed must launch; prints
     each part's wall and the phase's;
 16. the web gateway, the remote shell, the replacement flows and the
     doorman (client/webserver.py, finance/web.py, tools/web_explorer.py,
     client/shell.py, flows/replacement.py, node/registration.py) over
     one recording CudaBatchVerifier(batch_sizes=(128, 4096)), the
     in-process nodes' default verifier, the launch counters set to 0
     before 16a and read after 16c: (a) Hub (map host; a batching notary
     over distributed uniqueness with one member, 6 partitions, the
     commit-log store and QoS), Alice (ed25519), Bob (p256) and Carol
     (secp256k1) as port nodes over TCP and TLS, each booted with
     web_port = 0 and the finance web API; through the gateways only:
     each payer issues to itself (POST /api/cash/issue), 3 payments to Hub,
     one per payer (POST /api/cash/pay; a payee that does
     not pay on keeps each backchain one payer long), one POST
     /api/flows/CashPaymentFlow from Bob to Carol and
     a double spend (POST /api/flows/FinalityFlow) answered 400 with the
     notary's conflict. Every balance over GET /api/cash/balances equal
     to the model; each node's /api/explorer/transactions lists what it
     recorded; every GET route of the node surface, the explorer and the
     planes (/perf, /device, /capacity, /wire, /qos, /tx/slowest,
     /statestore, /shards, /health, /healthz, /traces, /incidents)
     answers JSON on every node, 200, or the reference's 404 for the
     notary's planes on a payer, /metrics Prometheus text and /profile
     folded stacks; each node's /wire counts every request the phase
     made to it; Hub's /cluster sees the three peers fresh and GET
     /tx/<id> assembles a notarised payment's story. The same drive over
     verifier_backend = "cpu" gives the same transaction ids, refusal,
     balances, consumed refs and notary commits. Prints REST payments/s
     and card calls per REST payment; (b) `connect_remote` to Bob over
     the TLS fabric: a wrong password refused; `flow start
     CashPaymentFlow` to Hub completes, `flow watch` renders its steps
     and completes, `run vault_query_by` and `vault` list Bob's states;
     prints each command's seconds; (c) on MockNetwork over the same
     verifier, NotaryOne (validating) and NotaryTwo: a coin moved to
     NotaryTwo by NotaryChangeFlow (NotaryOne signs), spent under
     NotaryTwo, the old state's double spend refused by NotaryOne, an
     upgrade to a contract with no registered path refused and a
     registered ContractUpgradeFlow replacing a second coin; the ids,
     refusals and vaults equal to a CpuBatchVerifier run's; (d) an
     in-process PermissioningServer (auto-approve): `python -m
     corda_tpu_torch.node --initial-registration` exits 0 with its TLS
     chain stored; the node boots in process on it, serves its
     registered leaf and through its gateway issues and pays Alice once
     through Hub's notary; a second key for the same name exits 1 with
     the doorman's "legal name already in use", a rule-violating name
     exits non-zero before it asks. ed_ladder, wei_ladder_windowed and
     wei_ladder must launch; prints each part's seconds and the phase's;
 17. the samples (samples/irs_demo.py, simulation.py, simm_demo.py,
     simm_web.py, simm.py, pricing.py; finance/commodity.py under the
     SIMM book) over one recording CudaBatchVerifier(batch_sizes=(128,
     4096)), the launch counters set to 0 before 17a and read after
     17d's demos; each demo again over CpuBatchVerifier in this process,
     and every recorded transaction id, final state, trace and answer
     equal to the card's: (a) irs_demo.run(seed=42, n_fixings=3): the
     scheduler fires the fixings at 500, 507 and 514 bp, the rate
     oracle signing each Fix-only tear-off, and no date is left; the
     oracle refuses a wrong rate and a tear-off revealing every
     component (tests/test_samples.py's shape); prints the seconds and
     the card calls per fixing; (b) run_irs_simulation(seed=42): the
     trace, with FixingFlow and OracleSignHandler lines and flow-added
     and flow-removed events; (c) simm_demo.run at one trade per family
     (a swap, a swaption, an FX forward, a CDS, an equity option and a
     commodity forward: every risk class, psi aggregation): the recorded
     valuation equal to the CPU run's to the bit, and simm_im on the host
     over each party's recorded book equal to its margin; (d) the
     /api/simm API on an in-process gateway over MockNetwork (a
     swaption, GET portfolio/margin, the calculate POST, GET
     portfolio/valuations), the JSON equal to the CPU run's; then
     estimate_margins_batch on the card (float32, TF32 off) over 65,536
     seeded portfolios x 12 tenors against float64 bucket_margins, the
     max relative error held to 1e-4. ed_ladder must launch; prints
     each part's seconds and card calls and the phase's wall;
 18. the test kits and the tools (testing/fleet.py, testing/expect.py,
     tools/demobench.py, web_demobench.py, explorer.py, models.py,
     graphs.py) on the card, the launch counters set to 0 before 18a
     and read after 18b: (a) the fleet soak at tests/test_fleet.py's
     batching shape (1,024 client identities, key pool 8, seed 11;
     ramp 3 rounds x 4, steady 14 x 8, a spike of 8 x 24 with 34% bulk,
     steady2 8 x 6; 6% injected double spends, a 6-round deadline, 60
     drain rounds; a frozen pump from 12% to 22% of the stream; the
     fixed 8-spend QoS policy) over one recording
     CudaBatchVerifier(batch_sizes=(128, 4096)): every p256 notary
     flush on the card; the checker reconciles the ledger, the SLO
     (p99 inside 5 rounds), the brownout and the health story, and
     every record's outcome, answer time and shed reason equal the same
     soak's over CpuBatchVerifier, run in a child process beside it;
     prints the seconds, the card calls, the rows per call and the
     launches; (b) the fault arc: 16 clients, 6 rounds x 4, 20%
     conflicts, seed 13, the intent WAL and a verifier pool of 2 whose
     workers verify on the card (divergence D10), worker 0 killed at
     30% of the stream: the checker's reconciliation and exact
     accounting, no intent left unresolved, every pool request
     resolved; a device_fault soak over the card (the default verifier
     and the recording one) is refused with ValueError naming D2;
     (c) web_demobench served on port 0: the validating notary Hub (the
     map host), then Alice and Bob added through /api/bench/add as
     node processes on the card (verifier_backend "tpu"); over Alice's
     RPC, ExplorerSimulation(currencies=("USD",), seed=5) runs 6 steps,
     each flow awaited; a NodeMonitorModel's transaction feed, recorded
     through the steps, matches an expect sequence built from the step
     log, in order and strictly; its balances equal a vault query's;
     Explorer renders and graphs draws the dot digraph of Alice's
     verified transactions; one CUDA context per node process; SIGTERM
     ends each with exit code 0. wei_ladder_windowed must launch in
     18a-18b; prints each part's seconds and the phase's wall;
 19. several cards and the kernel store on the one card, the launch
     counters set to 0 before 19a and read after 19b: (a) phase 5's
     corpus as a 4,096-row mixed call (even thirds ed25519 / secp256k1 /
     p256) through CudaBatchVerifier(mesh=make_mesh([cuda:0] * 4)), so
     each padded chunk splits into four slices on the one card (in each
     scheme's 4,096-row chunk one full slice, one partial, two of
     padding only, which are not launched), the answers gathered back
     into request order, every row equal to the CPU reference of its
     distinct request; (b) the
     phase-6 fixture's first 4,096 spends through a 4-shard
     BatchingNotaryService whose shards verify on
     per_shard_verifiers(4, devices=[cuda:0]) (one device: four unpinned
     verifiers), held as phase 6 holds its passes, each of the four
     verifiers dispatched; (c) CudaBatchVerifier(mesh=..., device=...)
     refused with ValueError; (d) crypto/aot_store.prewarm on the
     libraries phase 2 built, which it must reuse, one valid and one
     tampered row per scheme. The three kernels of 19a and the two of
     19b must launch; prints each part's seconds and the phase's wall;
 20. print the kernel table as one JSON line (all eight kernels, the
     prologue and epilogue rows with phase 4's times and bounds, p256's
     for the ECDSA ones; with each kernel's launches in phase 10 as "clusters_launches", in 11a-11b as
     "nodes_launches", in 12b-12d as "drives_launches", in 13a-13c as
     "telemetry_launches", in 14a-14d as "planes_launches", in 15a-15c
     as "xshard_launches", in 16a-16d as "web_launches", in 17a-17d as
     "samples_launches", in 18a-18b as "fleet_launches" and in 19a-19b
     as "shards_launches"), then the result line {"ok": true, "device":
     {...}}.

Imports nothing of JAX or of the corda_tpu package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
from contextlib import contextmanager
from concurrent.futures import ThreadPoolExecutor
import random
import subprocess
import sys
import time

CHUNK = 4096
FLUSH = 16384
NOTARY_SPENDS = 16384
NOTARY_SAMPLE = 256
NOTARY_PASSES = ("warm-up", "timed")
NOTARY_FIXTURE: dict = {}    # build_fixture's defaults: 1 in 64 bad, 1 in 256 wrong notary
SCHEME_BASE = 64             # phase 7: phase-6 spends beside the every-scheme ones
SCHEME_BATCHES = (128, 4096)
PARITY_B = 256
RAGGED_B = 130
PARITY_SIZES = (PARITY_B, RAGGED_B, 1)
# the prologues and epilogues run a row per group of 4 lanes: also a
# partial group and a ragged group at the chunk's end
ENDS_PARITY_SIZES = PARITY_SIZES + (3, CHUNK + 1)
DISTINCT = 256
IMAD_PER_SM_PER_CLK = 64     # CUDA C Programming Guide, throughput table, cc 9.0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()   # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _affine(curve, X, Y, Z):
    """Host normalisation of [22, B] projective Montgomery limbs:
    affine (x, y) ints per row, None at infinity."""
    from corda_tpu_torch.crypto import limbs as L

    xs, ys, zs = (L.batch_to_ints(t.cpu().numpy()) for t in (X, Y, Z))
    out = []
    for x, y, z in zip(xs, ys, zs):
        z %= curve.p
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, curve.p)
            out.append(((x * zi) % curve.p, (y * zi) % curve.p))
    return out


def _ed_affine(curve, X, Y, Z, T):
    """Host normalisation of [22, B] extended Montgomery limbs: affine
    (x, y) ints per row; raises unless X*Y == Z*T (mod p)."""
    from corda_tpu_torch.crypto import limbs as L

    p = curve.p
    out = []
    for i, (x, y, z, t) in enumerate(zip(*(L.batch_to_ints(c.cpu().numpy()) for c in (X, Y, Z, T)))):
        if (x * y - z * t) % p:
            raise RuntimeError(f"{curve.name} row {i}: X*Y != Z*T")
        zi = pow(z, -1, p)
        out.append(((x * zi) % p, (y * zi) % p))
    return out


def _normalise(curve, pt):
    return _ed_affine(curve, *pt) if len(pt) == 4 else _affine(curve, *pt)


def _max_err(curve, got, want, label: str) -> int:
    """Largest coordinate difference of the normalised points; raises
    unless every row is equal (integers: equality is the tolerance)."""
    import torch

    torch.cuda.synchronize()
    err = 0
    for i, (a, b) in enumerate(zip(_normalise(curve, got), _normalise(curve, want))):
        if a != b:
            raise RuntimeError(f"{label} row {i}: kernel {a} != plain {b}")
        if a is not None:
            err = max(err, abs(a[0] - b[0]), abs(a[1] - b[1]))
    return err


def _ladder_inputs(curve, batch: int, seed: int, device, wide: bool = True):
    """u1, u2, qx_m, qy_m at `batch` rows with the edge rows first; with
    `wide`, every 4th row's scalars use all 264 digit bits, else every
    scalar is below n, as the main path gives them."""
    import torch

    from corda_tpu_torch.crypto import limbs as L
    from corda_tpu_torch.crypto import modmath as M
    from corda_tpu_torch.crypto import refmath

    rng = random.Random(seed)
    G = (curve.gx, curve.gy)
    u1s, u2s, qs = [0, 7, 5, 9], [11, 0, 13, curve.n - 9], [None, None, G, G]
    for i in range(4, batch):
        top = wide and i % 4 == 0
        u1s.append(rng.getrandbits(264) if top else rng.randrange(curve.n))
        u2s.append(rng.getrandbits(264) if top else rng.randrange(curve.n))
        qs.append(None)
    distinct = [refmath.wei_mul(curve, rng.randrange(1, curve.n), G) for _ in range(16)]
    qs = [q if q is not None else distinct[i % 16] for i, q in enumerate(qs)]
    u1s, u2s, qs = u1s[:batch], u2s[:batch], qs[:batch]

    def dev(xs):
        return torch.from_numpy(L.ints_to_batch(xs)).to(device)

    qx_m = M.to_mont(curve.fp, dev([q[0] for q in qs]))
    qy_m = M.to_mont(curve.fp, dev([q[1] for q in qs]))
    return (dev(u1s), dev(u2s), qx_m, qy_m), (u1s, u2s, qs)


def _ed_inputs(batch: int, seed: int, device, wide: bool = True):
    """s, k, ax_m, ay_m for the Edwards ladders at `batch` rows. With
    `wide`, the edge rows come first (s=0, k=0, A=identity, s=L, s+L,
    all-264-bit scalars, A of order 2 and of order 4) and every 4th row
    uses all 264 digit bits; else s, k < L and A in the prime-order
    subgroup, as the main path gives them (but for s + L rows)."""
    import torch

    from corda_tpu_torch.crypto import limbs as L
    from corda_tpu_torch.crypto import modmath as M
    from corda_tpu_torch.crypto import refmath
    from corda_tpu_torch.crypto.curves import ED25519 as c

    rng = random.Random(seed)
    B = (c.gx, c.gy)
    distinct = [refmath.ed_mul(c, rng.randrange(1, c.L), B) for _ in range(16)]
    ss, ks, As = [], [], []
    if wide:
        sqrt_m1 = pow(2, (c.p - 1) // 4, c.p)
        ss = [0, 5, 9, c.L, c.L + 3, rng.getrandbits(264), 6, 10]
        ks = [7, 0, 4, 8, 6, rng.getrandbits(264), 5, 3]
        As = [distinct[0], distinct[1], (0, 1), distinct[2], distinct[3], distinct[4],
              (0, c.p - 1), (sqrt_m1, 0)]
    for i in range(len(ss), batch):
        top = wide and i % 4 == 0
        ss.append(rng.getrandbits(264) if top else rng.randrange(c.L))
        ks.append(rng.getrandbits(264) if top else rng.randrange(c.L))
        As.append(distinct[i % 16])
    ss, ks, As = ss[:batch], ks[:batch], As[:batch]

    def dev(xs):
        return torch.from_numpy(L.ints_to_batch(xs)).to(device)

    ax_m = M.to_mont(c.fp, dev([a[0] for a in As]))
    ay_m = M.to_mont(c.fp, dev([a[1] for a in As]))
    return (dev(ss), dev(ks), ax_m, ay_m), (ss, ks, As)


MUL_OPS = 2 * (64 + 64) + 8   # 256-bit Montgomery multiply: 8x8 + 8x8 products (2 IMAD each) + 8 low halves
SQR_OPS = 2 * (36 + 64) + 8   # a square: 36 distinct products
# mod 2^255 - 19 (special form): 8x8 products and the high half's 8 words
# times 38 (2 IMAD each); a square: 36 distinct products
ED_MUL_OPS = 2 * (64 + 8)
ED_SQR_OPS = 2 * (36 + 8)


def _cost(mults: int, squares: int = 0, mul: int = MUL_OPS, sqr: int = SQR_OPS) -> int:
    return mults * mul + squares * sqr


def _ed_cost(mults: int, squares: int = 0) -> int:
    return _cost(mults, squares, ED_MUL_OPS, ED_SQR_OPS)


# Edwards (a = -1), each without its T3 product, "t", which _ladder_ops
# counts only where the result must carry T: add-2008-hwcd-3 of a cached
# operand (Y - X, Y + X, 2Z, 2dT) 7M, of a cached affine one (Z2 = 1) 6M,
# dbl-2008-hwcd 3M + 4S; special-form multiplies ("mul": the conversions
# in and out too)
ED_COST = {"add": _ed_cost(7), "madd": _ed_cost(6), "dbl": _ed_cost(3, 4), "t": _ed_cost(1),
           "mul": ED_MUL_OPS}


def _wei_cost(curve) -> dict:
    """RCB15 complete formulas (Renes-Costello-Batina 2016, table 1) for
    a = 0 or a = -3: add 12M + 2 by b, mixed add 11M + 2 by b, doubling
    6M + 2S + 1 by 3b (a = 0) or 8M + 3S + 2 by b (a = -3)."""
    a = curve.a % curve.p
    if a not in (0, curve.p - 3):
        raise ValueError(f"{curve.name}: no dedicated formulas for a = {curve.a}")
    return {"add": _cost(14), "madd": _cost(13), "dbl": _cost(7, 2) if a == 0 else _cost(10, 3), "t": 0,
            "mul": MUL_OPS}


def _step_adds(cost: dict, windowed: bool, x: int, y: int, i: int) -> list:
    """Costs of the adds step i (bit i, or w=4 window i) of R = x*P + y*Q
    needs: none for a zero bit or digit, a mixed add where the operand is
    affine (P, Q, the constant P table), a full add for P + Q or a Q
    multiple."""
    if not windowed:
        pair = ((x >> i) & 1, (y >> i) & 1)
        return [] if pair == (0, 0) else [cost["add"] if pair == (1, 1) else cost["madd"]]
    ds, dk = (x >> 4 * i) & 15, (y >> 4 * i) & 15
    return [cost["madd"]] * (ds > 0) + [cost["madd"] if dk == 1 else cost["add"]] * (dk > 0)


def _ladder_ops(cost: dict, conv_mults: int, windowed: bool, xs, ys) -> int:
    """IMAD-rate instructions the kernel's schedule (plain Shamir, or w=4
    windows) needs for these scalars: each row scans only its scalars'
    bits; doublings at the dedicated doubling formula's cost; no add of
    the identity, and the top step's add a copy; the table the row needs
    (P + Q, or Q multiples 2..15 as 7 doublings and 7 mixed adds; the P
    table is constant). Edwards results carry T (cost["t"]) only where
    an add follows (the doubling before a step's adds, the first of a
    step's two adds), in table entries, and in the result unless it is
    the top step's copy. `conv_mults` multiplies (cost["mul"] each)
    convert the point in and the result out; the entry folds of the two
    input coordinates add 2 x 4 x 8 products."""
    width = 4 if windowed else 1
    t = cost["t"]
    ops = 0
    for x, y in zip(xs, ys):
        steps = -(-max(x.bit_length(), y.bit_length()) // width)
        if steps:
            adds = [_step_adds(cost, windowed, x, y, i) for i in range(steps)]
            ops += sum(map(sum, adds)) - max(adds[-1]) + width * (steps - 1) * cost["dbl"]
            ops += t * (sum(map(len, adds[:-1])) + (steps > 1 or len(adds[-1]) == 2))
            if windowed and y:
                ops += 7 * (cost["dbl"] + cost["madd"] + 2 * t)
            elif not windowed and x & y:
                ops += cost["madd"] + t
        ops += conv_mults * cost["mul"] + 2 * 4 * 8 * 2
    return ops


def _wei_ops(curve, windowed: bool, u1s, u2s) -> int:
    return _ladder_ops(_wei_cost(curve), 5, windowed, u1s, u2s)


def _ed_ops(windowed: bool, ss, ks) -> int:
    # 2 multiplies into the kernel's domain, T = x*y, 4 back to the 2^264 domain
    return _ladder_ops(ED_COST, 7, windowed, ss, ks)


# The verify program's kernels around the ladders (csrc/ed_ends.cu,
# csrc/wei_ends.cu): source, and what they replace (no Pallas kernel: the
# reference's lax.scan programs, modmath.mont_pow_const)
ENDS = {
    "ed_prologue": ("corda_tpu_torch/csrc/ed_ends.cu",
                    "corda_tpu/crypto/eddsa.py:100 (lax.scan program; no pallas_call)"),
    "ed_epilogue": ("corda_tpu_torch/csrc/ed_ends.cu",
                    "corda_tpu/crypto/ec.py:404 (lax.scan program; no pallas_call)"),
    "ecdsa_prologue": ("corda_tpu_torch/csrc/wei_ends.cu",
                       "corda_tpu/crypto/ecdsa.py:72 (lax.scan program; no pallas_call)"),
    "ecdsa_epilogue": ("corda_tpu_torch/csrc/wei_ends.cu",
                       "corda_tpu/crypto/ecdsa.py:97 (XLA program; no pallas_call)"),
}
# multiplies, squares and entry folds per row of each kernel, as the
# source runs them: chain_250 is 249 squares + 10 multiplies, then the
# square root's 2 + 1 or the inverse's 5 + 1; pow_n's table s^2 (a
# square) and s^3 .. s^15 (13 multiplies), then 4 squares per window
# below the top one (252) and a multiply per such window that is not 0
# (added in _ends_ops); load_coord a multiply and a fold, store_coord a
# multiply. The ed25519 pair works on plain values: no multiply into a
# Montgomery domain or out of it
ENDS_WORK = {
    "ed_prologue": (21, 255, 0),
    "ed_epilogue": (16, 254, 3),
    "ecdsa_prologue": (11 + 13, 2 + 1 + 252, 0),
    "ecdsa_epilogue": (5, 0, 2),
}
INV_WINDOW = 4               # bits per window of the ECDSA prologue's s^(n - 2)
# bytes per row each kernel must move: the record bytes it reads, its
# [22, B] int32 digit operands (88 bytes each), its [B] int32 signs and
# bool masks, and its outputs
ENDS_BYTES = {
    "ed_prologue": 96 + 4 + 1 + 4 * 88 + 1,      # s | k | A.y, a_sign, valid_in; s, k, -A.x, A.y, ok
    "ed_epilogue": 3 * 88 + 32 + 4 + 1 + 1,      # X, Y, Z, R.y, exp_sign, ok; verdict
    "ecdsa_prologue": 160 + 1 + 4 * 88 + 1,      # z | r | s | qx | qy, valid_in; u1, u2, qx, qy, valid
    "ecdsa_epilogue": 2 * 88 + 32 + 1 + 1,       # X, Z, r, valid; verdict
}


def _window_mults(e: int) -> int:
    """Multiplies of a fixed-window power with exponent e (256 bits):
    one per INV_WINDOW-bit window below the top one that is not 0."""
    mask = (1 << INV_WINDOW) - 1
    return sum(1 for i in range(256 // INV_WINDOW - 1) if (e >> (INV_WINDOW * i)) & mask)


def _ends_ops(name: str, curve, batch: int) -> int:
    """IMAD-rate instructions `batch` rows of kernel `name` need, at the
    curve's costs per multiply and square (_ed_cost for ed25519's
    special-form p, _cost for the ECDSA moduli, as the ladders' bounds)
    and 4 x 8 products (2 IMAD each) per entry fold; the same for every
    row (the kernels have no data-dependent branch)."""
    mults, squares, folds = ENDS_WORK[name]
    if name == "ecdsa_prologue":
        mults += _window_mults(curve.n - 2)
    cost = _ed_cost if name in ED_ENDS else _cost
    return batch * (cost(mults, squares) + folds * 4 * 8 * 2)


def _ends_fns(name: str):
    """(kernel, plain version) of `name`, each called as fn(curve, *args)."""
    from corda_tpu_torch.crypto import cuda_ec, ecdsa, eddsa

    kern = getattr(cuda_ec, name + "_cuda")
    if name in ECDSA_ENDS:
        return kern, getattr(ecdsa, name + "_plain")
    plain = getattr(eddsa, name + "_plain")
    return (lambda curve, *a: kern(*a)), (lambda curve, *a: plain(*a))


def _ends_inputs(name: str, curve, batch: int, seed: int, device) -> tuple:
    """Arguments of kernel `name` at `batch` rows on `device`:
    testing/selfcheck.py's rows, the crafted edge rows first (rows(n)
    are the first n rows of rows(m) for n <= m)."""
    import numpy as np
    import torch

    from corda_tpu_torch.testing import selfcheck

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    if name == "ed_prologue":
        return tuple(dev(a) for a in selfcheck.ed25519_prologue_rows(batch, seed))
    if name == "ecdsa_prologue":
        return tuple(dev(a) for a in selfcheck.ecdsa_prologue_rows(curve, batch, seed))
    if name == "ed_epilogue":
        R, *rest = selfcheck.ed25519_epilogue_rows(batch, seed)
    else:
        R, *rest = selfcheck.ecdsa_epilogue_rows(curve, batch, seed)
    return (tuple(dev(x) for x in R), *(dev(a) for a in rest))


def _ends_equal(curve, got, want, label: str) -> int:
    """0 where every output of a prologue or epilogue kernel equals its
    plain version's first rows: verdicts and raw digits (s, k, u1, u2)
    exactly, points (the plain version's lazily reduced) mod p, the
    kernel's digits canonical; raises otherwise."""
    import torch

    from corda_tpu_torch.crypto import limbs as L

    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu()
        w = w.cpu()[..., : g.shape[-1]]
        if g.dtype == torch.bool or i < 2:
            bad = (g != w).reshape(-1, g.shape[-1]).any(0).nonzero().flatten().tolist()
        else:
            a, b = L.batch_to_ints(g.numpy()), L.batch_to_ints(w.numpy())
            bad = [j for j in range(len(a)) if a[j] >= curve.p or (a[j] - b[j]) % curve.p]
            if int(g.min()) < 0 or int(g.max()) >= 4096:
                bad = bad or [-1]
        if bad:
            raise RuntimeError(f"{label} output {i}: kernel != plain at rows {bad[:8]}")
    return 0


def phase_parity(device, report: dict) -> None:
    from corda_tpu_torch.crypto import cuda_ec, refmath
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    kernels = {
        "wei_ladder_windowed": (cuda_ec.wei_ladder_windowed_cuda, cuda_ec.wei_ladder_windowed_plain),
        "wei_ladder": (cuda_ec.wei_ladder_cuda, cuda_ec.wei_ladder_plain),
    }
    big = max(PARITY_SIZES)
    for name, (kern, plain) in kernels.items():
        err = 0
        for curve in (SECP256R1, SECP256K1):
            # one plain call (torch-op bound whatever its rows); the kernel
            # at each size against that call's first rows
            full, (u1s, u2s, qs) = _ladder_inputs(curve, big, 7, device)
            want = plain(curve, *full)
            for batch in PARITY_SIZES:
                args = [a[:, :batch].contiguous() for a in full]
                out = kern(curve, *args)
                label = f"{name} {curve.name} B={batch}"
                err = max(err, _max_err(curve, out, [w[:, :batch] for w in want], label))
                got = _affine(curve, *out)
                G = (curve.gx, curve.gy)
                for i in range(min(8, batch)):   # and the plain version against refmath
                    ref = refmath.wei_add(
                        curve, refmath.wei_mul(curve, u1s[i], G), refmath.wei_mul(curve, u2s[i], qs[i])
                    )
                    if ref != got[i]:
                        raise RuntimeError(f"{label} row {i}: {got[i]} != refmath {ref}")
                if batch > 3 and got[3] is not None:
                    raise RuntimeError(f"{label}: u2 = n - u1, Q = G must give infinity")
                print(f"parity {label}: {batch} rows equal")
        _note_err(report, name, err)

    c = ED25519
    ed_kernels = {
        "ed_ladder_windowed": (cuda_ec.ed_ladder_windowed_cuda, cuda_ec.ed_ladder_windowed_plain),
        "ed_ladder": (cuda_ec.ed_ladder_cuda, cuda_ec.ed_ladder_plain),
    }
    for name, (kern, plain) in ed_kernels.items():
        err = 0
        full, (ss, ks, As) = _ed_inputs(big, 7, device)
        want = plain(c, *full)
        for batch in PARITY_SIZES:
            args = [a[:, :batch].contiguous() for a in full]
            out = kern(c, *args)
            err = max(err, _max_err(c, out, [w[:, :batch] for w in want], f"{name} B={batch}"))
            got = _ed_affine(c, *out)
            B = (c.gx, c.gy)
            for i in range(min(8, batch)):   # and against refmath
                ref = refmath.ed_add(c, refmath.ed_mul(c, ss[i], B), refmath.ed_mul(c, ks[i], As[i]))
                if ref != got[i]:
                    raise RuntimeError(f"{name} row {i}: {got[i]} != refmath {ref}")
            print(f"parity {name} ed25519 B={batch}: {batch} rows equal")
        _note_err(report, name, err)

    for name in ENDS:
        kern, plain = _ends_fns(name)
        for curve in ((SECP256R1, SECP256K1) if name in ECDSA_ENDS else (ED25519,)):
            # one plain call; the kernel at each size against its first rows
            want = plain(curve, *_ends_inputs(name, curve, max(ENDS_PARITY_SIZES), 7, device))
            for batch in ENDS_PARITY_SIZES:
                label = f"{name} {curve.name} B={batch}"
                got = kern(curve, *_ends_inputs(name, curve, batch, 7, device))
                _note_err(report, name, _ends_equal(curve, got, want, label))
                print(f"parity {label}: {batch} rows equal (edge rows first)")


def _note_err(report: dict, name: str, err) -> None:
    """The largest error of `name` seen so far (parity and timing run in
    either order)."""
    row = report.setdefault(name, {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], float(err))


def print_resources() -> None:
    """Registers, stack bytes, static shared bytes and resident warps per
    SM of every kernel instantiation, from the CUDA runtime."""
    from corda_tpu_torch.crypto import cuda_ec
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    for kernel, curve in (("wei_ladder", SECP256R1), ("wei_ladder", SECP256K1), ("ed_ladder", ED25519)):
        for name in (kernel + "_windowed", kernel):
            print(f"resources {name} {curve.name}: {cuda_ec.kernel_resources(name, curve)}")
    for name in ED_ENDS + ECDSA_ENDS:
        print(f"resources {name}: {cuda_ec.kernel_resources(name)}")


def _time_kernel(report: dict, name: str, curve, kern, plain, args, ops: int,
                 nbytes: int, rate: float, source: str, replaces: str) -> None:
    """Kernel ms (CUDA events, 5 launches), plain ms (one call, host
    clock around synchronise), equality at this size, and the bound."""
    import torch

    ms = _cuda_ms(lambda: kern(curve, *args), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(curve, *args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_err(curve, kern(curve, *args), want, f"{name} {curve.name} B={CHUNK}")
    _note_err(report, name, err)
    ops_ms, bytes_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    report[name].update(
        route="cuda", source=source, replaces=replaces,
        ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=None,
    )
    print(f"time {name} {curve.name} B={CHUNK}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {max(ops_ms, bytes_ms):.3f} ms ({ops / CHUNK:.0f} IMAD/signature)")


def phase_timing(device, report: dict) -> None:
    import torch

    from corda_tpu_torch.crypto import cuda_ec
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rate = IMAD_PER_SM_PER_CLK * sms * clock_mhz * 1e6
    print(f"bound model: {IMAD_PER_SM_PER_CLK} IMAD/clk/SM x {sms} SMs x {clock_mhz:.0f} MHz")
    wei = {
        "wei_ladder_windowed": (SECP256R1, True, cuda_ec.wei_ladder_windowed_cuda,
                                cuda_ec.wei_ladder_windowed_plain, "corda_tpu/crypto/pallas_ec.py:182"),
        "wei_ladder": (SECP256K1, False, cuda_ec.wei_ladder_cuda,
                       cuda_ec.wei_ladder_plain, "corda_tpu/crypto/pallas_ec.py:113"),
    }
    for name, (curve, windowed, kern, plain, replaces) in wei.items():
        args, (u1s, u2s, _) = _ladder_inputs(curve, CHUNK, 11, device, wide=False)
        _time_kernel(report, name, curve, kern, plain, args, _wei_ops(curve, windowed, u1s, u2s),
                     7 * 22 * 4 * CHUNK,      # 4 inputs read, 3 outputs written
                     rate, "corda_tpu_torch/csrc/wei_ladder.cu", replaces)
    ed = {
        "ed_ladder_windowed": (True, cuda_ec.ed_ladder_windowed_cuda,
                               cuda_ec.ed_ladder_windowed_plain, "corda_tpu/crypto/pallas_ec.py:249"),
        "ed_ladder": (False, cuda_ec.ed_ladder_cuda,
                      cuda_ec.ed_ladder_plain, "corda_tpu/crypto/pallas_ec.py:311"),
    }
    args, (ss, ks, _) = _ed_inputs(CHUNK, 13, device, wide=False)
    for name, (windowed, kern, plain, replaces) in ed.items():
        _time_kernel(report, name, ED25519, kern, plain, args, _ed_ops(windowed, ss, ks),
                     8 * 22 * 4 * CHUNK,      # 4 inputs read, 4 outputs written
                     rate, "corda_tpu_torch/csrc/ed_ladder.cu", replaces)


def _count_torch_ops(fn) -> int:
    """Non-view aten operations one call of fn dispatches (each is a
    kernel launch on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = ("view", "slice", "select", "expand", "alias", "squeeze", "t.default", "detach")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(v in func.__name__ for v in views):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _device_us(fn, kernel: str, reps: int) -> float:
    """Mean device time (µs) per launch of the CUDA kernel whose name
    holds `kernel` over `reps` calls of fn, from one torch.profiler
    window: the kernel alone, without the host time between launches
    that CUDA events around a loop also take in (a few-µs kernel's
    wrapper is slower than the kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, kernels = _kernel_intervals(prof.profiler.kineto_results.events())
    times = [end - start for start, end, name in kernels if kernel in name]
    if not times:
        raise RuntimeError(f"profiler: no device time for {kernel}")
    return sum(times) / len(times)


def phase_prologue(device, report: dict) -> None:
    """Phase 4: each prologue and epilogue kernel against its plain
    version at the main path's chunk, with its IMAD bound and its device
    time per launch (torch.profiler); then the torch ops of one whole
    verify call per scheme."""
    import torch

    from corda_tpu_torch.crypto import ecdsa, eddsa
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rate = IMAD_PER_SM_PER_CLK * sms * clock_mhz * 1e6
    for name, (source, replaces) in ENDS.items():
        kern, plain = _ends_fns(name)
        for curve in ((SECP256R1, SECP256K1) if name in ECDSA_ENDS else (ED25519,)):
            args = _ends_inputs(name, curve, CHUNK, 11, device)
            ms = _cuda_ms(lambda: kern(curve, *args), reps=20)
            dev_us = _device_us(lambda: kern(curve, *args), name + "_kernel", reps=20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(curve, *args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = kern(curve, *args)
            _note_err(report, name, _ends_equal(curve, got, want, f"{name} {curve.name} B={CHUNK}"))
            nbytes = ENDS_BYTES[name] * CHUNK
            ops = _ends_ops(name, curve, CHUNK)
            ops_ms, bytes_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            if curve is not SECP256K1:   # the table's row: p256 for the ECDSA kernels
                report[name].update(
                    route="cuda", source=source, replaces=replaces, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(ops_ms, bytes_ms),
                    bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=None)
            print(f"time {name} {curve.name} B={CHUNK}: kernel {ms:.3f} ms (device {dev_us:.1f} "
                  f"µs/launch, torch.profiler), plain {plain_ms:.1f} ms, "
                  f"bound {max(ops_ms, bytes_ms):.4f} ms ({ops / CHUNK:.0f} IMAD/row, "
                  f"{nbytes / CHUNK:.0f} bytes/row)")

    packed, a_sign, valid = _ends_inputs("ed_prologue", ED25519, CHUNK, 11, device)
    zeros = torch.zeros_like(a_sign)
    calls = {"ed25519": lambda: eddsa.ed25519_verify_packed(packed, a_sign, zeros, valid)}
    for tag, curve in (("p256", SECP256R1), ("secp256k1", SECP256K1)):
        rec, ok = _ends_inputs("ecdsa_prologue", curve, CHUNK, 11, device)
        calls[tag] = lambda curve=curve, rec=rec, ok=ok: ecdsa.ecdsa_verify_packed(curve, rec, ok)
    for tag, fn in calls.items():
        ms = _cuda_ms(fn, reps=5)
        ops = _count_torch_ops(fn)
        print(f"time verify_packed {tag} B={CHUNK}: {ms:.3f} ms (CUDA events), {ops} torch ops")
        if ops >= 100:
            raise RuntimeError(f"verify_packed {tag}: {ops} torch ops per {CHUNK}-row call, "
                               "not a handful of launches")


def _dispatch_order(reqs) -> list:
    """Request indices in the order the verifier dispatches them: one
    bucket per scheme, in the order of each scheme's first row."""
    buckets: dict = {}
    for i, r in enumerate(reqs):
        buckets.setdefault(r.key.scheme_id, []).append(i)
    return [i for idxs in buckets.values() for i in idxs]


def _flush(verifier, reqs, expect, label: str) -> None:
    t0 = time.perf_counter()
    pv = verifier.verify_batch_async(reqs)
    streamed = []
    for idxs, vals in pv.chunks():
        for i, ok in zip(idxs, vals):
            if ok != expect[i]:
                raise RuntimeError(f"{label} row {i}: device {ok} != CPU {expect[i]}")
        streamed.extend(idxs)
    wall = time.perf_counter() - t0
    if streamed != _dispatch_order(reqs):
        raise RuntimeError(f"{label}: {len(streamed)} rows of {len(reqs)} streamed, "
                           "not once each in dispatch order")
    dev_s = pv.device_seconds()
    print(f"main {label}: {len(reqs)} rows in {wall:.3f} s = {len(reqs) / wall:.0f} verifies/s; "
          f"host staging {pv.stage_seconds:.3f} s, device (chunk events, summed) {dev_s:.3f} s")


COUNTERS = {
    "wei_ladder_windowed": "wei_ladder_windowed_launches",
    "wei_ladder": "wei_ladder_launches",
    "ed_ladder_windowed": "ed_ladder_windowed_launches",
    "ed_ladder": "ed_ladder_launches",
    "ed_prologue": "ed_prologue_launches",
    "ed_epilogue": "ed_epilogue_launches",
    "ecdsa_prologue": "ecdsa_prologue_launches",
    "ecdsa_epilogue": "ecdsa_epilogue_launches",
}
ED_ENDS = ("ed_prologue", "ed_epilogue")
ECDSA_ENDS = ("ecdsa_prologue", "ecdsa_epilogue")


def spi_corpus():
    """Phase 5's corpus: DISTINCT seeded requests per scheme with tampered
    rows (and the ed25519 edge rows), each held by the CPU reference to
    its construction label; returns tiled(sids, rows) -> (requests, the
    CPU reference's decision per row)."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.selfcheck import (
        TAMPERED_KINDS,
        build_requests,
        ed25519_edge_requests,
    )

    p256, k1, ed = (schemes.ECDSA_SECP256R1_SHA256, schemes.ECDSA_SECP256K1_SHA256,
                    schemes.EDDSA_ED25519_SHA512)
    distinct, ok = {}, {}
    for sid in (p256, k1, ed):
        edges = [r for _, r in ed25519_edge_requests()] if sid == ed else []
        n = DISTINCT - len(edges)
        distinct[sid] = build_requests(n, seed=sid, scheme_ids=(sid,)) + edges
        ok[sid] = CpuBatchVerifier().verify_batch(distinct[sid])
        if ok[sid][:n] != [i % 8 not in TAMPERED_KINDS for i in range(n)]:
            raise RuntimeError(f"scheme {sid}: CPU reference disagrees with the construction labels")

    def tiled(sids, rows):
        """rows requests cycling over sids, each scheme's distinct set
        tiled; with the CPU reference's decision per row"""
        picks = [(sids[i % len(sids)], (i // len(sids)) % DISTINCT) for i in range(rows)]
        return [distinct[s][j] for s, j in picks], [ok[s][j] for s, j in picks]

    return tiled


def phase_main(device, report: dict) -> None:
    from corda_tpu_torch.crypto import cuda_ec, schemes
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier

    p256, k1, ed = (schemes.ECDSA_SECP256R1_SHA256, schemes.ECDSA_SECP256K1_SHA256,
                    schemes.EDDSA_ED25519_SHA512)
    tiled = spi_corpus()
    plain = CudaBatchVerifier(batch_sizes=(128, 1024, 4096), device=device)
    windowed = CudaBatchVerifier(batch_sizes=(128, 1024, 4096), device=device, windowed=True)
    # (label, verifier, schemes, rows, kernels that must launch)
    paths = [
        ("p256 flush", plain, (p256,), FLUSH, ("wei_ladder_windowed", *ECDSA_ENDS)),
        ("secp256k1 batch", plain, (k1,), CHUNK, ("wei_ladder", *ECDSA_ENDS)),
        ("ed25519 flush", plain, (ed,), FLUSH, ("ed_ladder", *ED_ENDS)),
        ("ed25519 windowed batch", windowed, (ed,), CHUNK, ("ed_ladder_windowed", *ED_ENDS)),
        ("mixed flush (ed25519 / secp256k1 / p256)", plain, (ed, k1, p256), FLUSH,
         ("ed_ladder", "wei_ladder", "wei_ladder_windowed", *ED_ENDS, *ECDSA_ENDS)),
    ]
    for label, verifier, sids, _, _ in paths:    # warm-up: allocator, library load
        reqs, expect = tiled(sids, DISTINCT)
        _flush(verifier, reqs, expect, label + " warm-up")

    for label, verifier, sids, rows, must in paths:
        reqs, expect = tiled(sids, rows)
        for counter in COUNTERS.values():
            setattr(cuda_ec, counter, 0)
        _flush(verifier, reqs, expect, label)
        launches = {name: getattr(cuda_ec, counter) for name, counter in COUNTERS.items()}
        print(f"main {label} launches: {launches}")
        for name in must:
            if launches[name] == 0:
                raise RuntimeError(f"{name} was not launched on the {label}")
            report[name].setdefault("launches", launches[name])


def _recording_verifier(batch_sizes, device):
    """A CudaBatchVerifier that keeps each dispatch's requests and handle
    (in `.calls`) for the checks."""
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier

    class Recording(CudaBatchVerifier):
        def verify_batch_async(self, requests):
            pv = super().verify_batch_async(requests)
            self.calls.append((list(requests), pv))
            return pv

    verifier = Recording(batch_sizes=batch_sizes, device=device)
    verifier.calls = []
    return verifier


def _zero_counters() -> None:
    from corda_tpu_torch.crypto import cuda_ec

    for counter in COUNTERS.values():
        setattr(cuda_ec, counter, 0)


def _read_counters() -> dict:
    from corda_tpu_torch.crypto import cuda_ec

    return {name: getattr(cuda_ec, counter) for name, counter in COUNTERS.items()}


def _check_codecs(wire: list, card: str) -> None:
    """Phase 6's codec check, outside the timed passes: the native and
    the Python codec on every spend's wire bytes. Raises on any
    difference in bytes, transaction ids or Merkle roots; prints each
    path's seconds per spend."""
    import hashlib

    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.crypto import merkle
    from corda_tpu_torch.crypto.hashes import SecureHash

    def py_id(wtx):
        return merkle.merkle_root_py([
            SecureHash(hashlib.sha256(ser.encode_py([g, i, c])).digest())
            for g, i, c in wtx.component_leaves()])

    n = len(wire)
    t0 = time.perf_counter()
    nat = [ser.decode(b) for b in wire]
    t1 = time.perf_counter()
    nat_ids = [stx.id for stx in nat]
    t2 = time.perf_counter()
    nat_wire = [ser.encode(stx) for stx in nat]
    t3 = time.perf_counter()
    py = [ser.decode_py(b) for b in wire]
    t4 = time.perf_counter()
    py_ids = [py_id(stx.wtx) for stx in py]
    t5 = time.perf_counter()
    py_wire = [ser.encode_py(stx) for stx in py]
    t6 = time.perf_counter()
    for i in range(n):
        if not (nat_wire[i] == py_wire[i] == wire[i]):
            raise RuntimeError(f"codec check: spend {i} re-encodes differently (native/Python)")
        if nat_ids[i] != py_ids[i]:
            raise RuntimeError(f"codec check: spend {i} id {nat_ids[i]} (native) != {py_ids[i]} (Python)")
    root, proofs = merkle.single_leaf_proofs(nat_ids)
    root_py, proofs_py = merkle.single_leaf_proofs_py(py_ids)
    if root != root_py or root != merkle.merkle_root_py(py_ids) or proofs != proofs_py:
        raise RuntimeError("codec check: the Merkle root or proofs over the ids differ (native/Python)")
    us = 1e6 / n
    print(f"codec check: {n} spends byte-equal, ids equal, root over the ids "
          f"{root.bytes_.hex()[:16]} equal; us per spend native / Python: decode "
          f"{(t1 - t0) * us:.1f} / {(t4 - t3) * us:.1f}, id walk {(t2 - t1) * us:.1f} / "
          f"{(t5 - t4) * us:.1f}, encode {(t3 - t2) * us:.1f} / {(t6 - t5) * us:.1f}; {card}")


def _check_notary(fx, svc, answers, calls, label: str, sample_rows: int | None = None) -> dict:
    """Hold one notary pass to its fixture, with `sample_rows` of the
    card's verdicts (NOTARY_SAMPLE by default) against CpuBatchVerifier;
    returns the pass's dispatch figures (host staging s, device s, rows)."""
    import random as _random

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import answer_kind

    kinds = [answer_kind(a) for a in answers]
    bad = [i for i, (k, want) in enumerate(zip(kinds, fx.labels)) if k != want]
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: {len(bad)} answers differ from their labels; spend {i}: "
                           f"{answers[i]!r}, label {fx.labels[i]}")
    for i, want in enumerate(fx.labels):
        if want == "conflict":   # the first spend of the pair won
            if list(answers[i].conflict.values()) != [fx.spends[i - 1].id]:
                raise RuntimeError(f"{label}: spend {i} lost to {answers[i].conflict}")
    n_ok = fx.labels.count("ok")
    if _committed_count(svc.uniqueness) != n_ok:
        raise RuntimeError(f"{label}: {_committed_count(svc.uniqueness)} inputs committed, "
                           f"{n_ok} accepted")
    reqs = [r for rs, _ in calls for r in rs]
    verdicts = [v for _, pv in calls for v in pv.result()]
    if len(reqs) != len(verdicts) or verdicts.count(False) != fx.labels.count("invalid-signature"):
        raise RuntimeError(f"{label}: the card rejected {verdicts.count(False)} of "
                           f"{len(verdicts)} rows")
    if sample_rows is None:
        sample_rows = NOTARY_SAMPLE
    sample = sorted(_random.Random(len(reqs)).sample(range(len(reqs)), min(sample_rows, len(reqs))))
    if CpuBatchVerifier().verify_batch([reqs[i] for i in sample]) != [verdicts[i] for i in sample]:
        raise RuntimeError(f"{label}: the card's verdicts differ from CpuBatchVerifier")
    signed = [i for i, k in enumerate(kinds) if k == "ok"]
    for i in signed[:: max(1, len(signed) // 8)][:8]:
        if not answers[i].is_valid(fx.spends[i].id):   # schemes.verify_one over its proof
            raise RuntimeError(f"{label}: the notary signature of spend {i} does not verify")
    if svc.degraded or svc.metrics.counter("Notary.DegradedFlushes").count:
        raise RuntimeError(f"{label}: the notary degraded: {svc.degraded_evidence}")
    return {"stage_s": sum(pv.stage_seconds for _, pv in calls),
            "device_s": sum(pv.device_seconds() for _, pv in calls), "rows": len(reqs)}


def notary_fixture():
    """The phase-6 fixture (NOTARY_SPENDS spends), built and described;
    a process that runs no phase 6 builds its own, the same."""
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    fx = build_fixture(NOTARY_SPENDS, **NOTARY_FIXTURE)
    counts = {k: fx.labels.count(k) for k in sorted(set(fx.labels))}
    print(f"notary fixture: {NOTARY_SPENDS} spends {counts}, {len(fx.issues)} issue "
          f"transactions, built in {fx.build_seconds:.1f} s, signing by "
          + ("OpenSSL" if fx.openssl else f"pure Python over {os.cpu_count()} processes"))
    return fx


def phase_notary(device, card: str) -> tuple:
    """The batching notary's flush over the card (phase 6); returns
    ({shards: notarisations/s of the last pass}, the fixture)."""
    import os

    os.environ["CORDA_TPU_NOTARY_PROFILE"] = "1"   # the notary's phase_seconds
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.node.notary import (
        BatchingNotaryService,
        InMemoryUniquenessProvider,
        ShardedUniquenessProvider,
        finish_process,
        run_process,
    )
    from corda_tpu_torch.testing.notary_fixture import notary_hub

    spends = NOTARY_SPENDS
    fx = notary_fixture()

    # the spends as a notary receives them: each pass decodes its own
    # copy, so no transaction id or Merkle root is cached from the last
    wire = [ser.encode(stx) for stx in fx.spends]
    _check_codecs(wire, card)
    verifier = _recording_verifier((CHUNK,), device)
    hub = notary_hub(fx, verifier)
    rates = {}
    for shards in (1, 4):
        def fresh():
            return ShardedUniquenessProvider(shards) if shards > 1 else InMemoryUniquenessProvider()

        svc = BatchingNotaryService(hub, fresh(), max_batch=spends, shards=shards,
                                    shard_workers=False, shard_queue_depth=spends,
                                    degraded_fallback=False)
        for pass_name in NOTARY_PASSES:
            label = f"notary shards={shards} {pass_name}"
            svc.uniqueness = fresh()
            verifier.calls = []
            svc.phase_seconds.clear()
            _zero_counters()
            td = time.perf_counter()
            received = [ser.decode(b) for b in wire]
            t0 = time.perf_counter()
            started = run_process([svc.process(stx, fx.requester) for stx in received])
            t1 = time.perf_counter()
            svc.flush()
            t2 = time.perf_counter()
            answers = finish_process(started)
            wall = time.perf_counter() - t0
            launches = _read_counters()
            disp = _check_notary(fx, svc, answers, verifier.calls, label)
            for kernel in ("ed_ladder", "wei_ladder_windowed"):
                if launches[kernel] == 0:
                    raise RuntimeError(f"{kernel} was not launched on the {label} pass")
            phases = {k: round(v, 6) for k, v in svc.phase_seconds.items()}
            print(f"{label}: {spends} spends in {wall:.3f} s = {spends / wall:.1f} notarisations/s "
                  f"(intake {t1 - t0:.3f} s, flush {t2 - t1:.3f} s; decode before it "
                  f"{t0 - td:.3f} s); {card}")
            print(f"{label} phase_seconds: {json.dumps(phases)}; {card}")
            print(f"{label} dispatch: {len(verifier.calls)} calls, {disp['rows']} rows, "
                  f"host staging {disp['stage_s']:.3f} s, device (chunk events, summed) "
                  f"{disp['device_s']:.3f} s; launches {launches}; {card}")
            rates[shards] = spends / wall
    return rates, fx


def phase_schemes(device, card: str, fx) -> dict:
    """Phase 7: one notary flush over every scheme and over attachment
    code (module docstring); returns the launches of its run."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import HOST_SCHEMES, CpuBatchVerifier
    from corda_tpu_torch.node.notary import (
        BatchingNotaryService,
        InMemoryUniquenessProvider,
        finish_process,
        run_process,
    )
    from corda_tpu_torch.testing.notary_fixture import (
        answer_kind,
        build_scheme_fixture,
        notary_hub,
    )

    t0 = time.perf_counter()
    rsa = schemes.generate_keypair(schemes.RSA_SHA256)
    sphincs = schemes.generate_keypair(schemes.SPHINCS256_SHA256, seed=SCHEME_BASE)
    sf = build_scheme_fixture(fx, rsa, sphincs, base=SCHEME_BASE)
    counts = {k: sf.kinds.count(k) for k in sorted(set(sf.kinds))}
    print(f"every-scheme fixture: {len(sf.spends)} spends {counts}, labels "
          f"{ {k: sf.labels.count(k) for k in sorted(set(sf.labels))} }, built in "
          f"{time.perf_counter() - t0:.1f} s")
    verifier = _recording_verifier(SCHEME_BATCHES, device)
    hub = notary_hub(fx, verifier)
    for data in sf.attachments:
        hub.attachments.import_attachment(data)
    svc = BatchingNotaryService(hub, InMemoryUniquenessProvider(), max_batch=len(sf.spends),
                                degraded_fallback=False)
    _zero_counters()
    t0 = time.perf_counter()
    started = run_process([svc.process(stx, fx.requester) for stx in sf.spends])
    svc.flush()
    answers = finish_process(started)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    label = "every-scheme flush"
    kinds = [answer_kind(a) for a in answers]
    bad = [i for i, (k, want) in enumerate(zip(kinds, sf.labels)) if k != want]
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: {len(bad)} answers differ from their labels; spend {i} "
                           f"({sf.kinds[i]}): {answers[i]!r}, label {sf.labels[i]}")
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched on the {label}")
    if len(verifier.calls) != 1 or svc.batches_dispatched != 1:
        raise RuntimeError(f"{label}: {len(verifier.calls)} dispatches, expected one")
    reqs, pv = verifier.calls[0]
    verdicts = pv.result()
    if CpuBatchVerifier().verify_batch(reqs) != verdicts:
        raise RuntimeError(f"{label}: the verdicts differ from CpuBatchVerifier")
    host = [i for i, r in enumerate(reqs) if r.key.scheme_id in HOST_SCHEMES]
    if pv.host_rows != host or len(host) != 6:
        raise RuntimeError(f"{label}: host rows {pv.host_rows}, expected {host} (6)")
    for i, k in enumerate(kinds):
        if k == "ok" and not answers[i].is_valid(sf.spends[i].id):
            raise RuntimeError(f"{label}: the notary signature of spend {i} does not verify")
    if svc.degraded or svc.metrics.counter("Notary.DegradedFlushes").count:
        raise RuntimeError(f"{label}: the notary degraded: {svc.degraded_evidence}")
    print(f"{label}: {len(sf.spends)} spends in {wall:.3f} s, every answer its label; "
          f"{len(reqs)} rows in one dispatch, host_rows {len(pv.host_rows)}, host_seconds "
          f"{pv.host_seconds:.6f}, host staging {pv.stage_seconds:.3f} s, device (chunk events, "
          f"summed) {pv.device_seconds():.3f} s; launches {launches}; {card}")
    return launches

FLOW_SEED = 11
FLOW_BATCHES = (128, 4096)
FLOW_PAYERS = 2              # phase 8b: payer nodes, ed25519 and p256 (8, 4 cut)
FLOW_COINS = 1               # phase 8b: issued coins per payer, one payment each (2 cut)
FLOW_SHARDS = (1, 4)         # phase 8b: the batching notary's shards


def _cash_of(node) -> int:
    """The node's own unspent Cash (states its legal key owns)."""
    from corda_tpu_torch.finance import CashState

    return sum(s.state.data.amount.quantity for s in node.vault.unconsumed_states(CashState)
               if s.state.data.owner == node.party.owning_key)


def flow_drive(verifier, seed: int = FLOW_SEED) -> dict:
    """Phase 8a, drive 1 through the flows over `verifier`: a validating
    notary, Bank and Alice (ed25519), Bob (p256), Carol (secp256k1).
    Bank issues to Alice; Alice pays Bob; Bob pays Carol and Carol pays
    Bank (each recipient resolves the backchain); a payment of Alice's
    is interrupted while it awaits the notary and restored from its
    checkpoint by a fresh state machine; a spend with a flipped signature
    byte is refused by FinalityFlow and by the notary; a double spend
    loses with a "conflict". Raises unless every outcome and balance is
    the expected one; returns the ledger (ids, notary signatures,
    balances, refusals) and the verify calls of each payment."""
    import dataclasses
    import random as _random

    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.tx_signature import InvalidSignature
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashMove
    from corda_tpu_torch.flows.core_flows import FinalityFlow, NotaryFlow
    from corda_tpu_torch.flows.statemachine import StateMachineManager
    from corda_tpu_torch.node.notary import NotaryException
    from corda_tpu_torch.testing import MockNetwork

    calls = getattr(verifier, "calls", [])    # a recording verifier's dispatches
    net = MockNetwork(seed=seed, batch_verifier=verifier)
    notary = net.create_notary("Notary", validating=True)
    bank = net.create_node("Bank")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob", scheme_id=schemes.ECDSA_SECP256R1_SHA256)
    carol = net.create_node("Carol", scheme_id=schemes.ECDSA_SECP256K1_SHA256)
    ledger = {"ids": [], "notary_sigs": [], "refused": [], "calls": {}}

    def record(label, stx, n_calls):
        ledger["ids"].append(str(stx.id))
        ledger["notary_sigs"].append(
            [s.signature.hex() for s in stx.sigs if s.by == notary.party.owning_key])
        ledger["calls"][label] = len(calls) - n_calls

    def run(label, node, logic):
        n_calls = len(calls)
        stx = node.run_flow(logic)
        record(label, stx, n_calls)
        return stx

    def refused(label, node, logic, exc_type, kind=None):
        try:
            node.run_flow(logic)
        except exc_type as e:
            got = getattr(getattr(e, "error", None), "kind", None)
            if got != kind:
                raise RuntimeError(f"flow drive: {label} refused as {got!r}, not {kind!r}: {e}")
            ledger["refused"].append([label, type(e).__name__, got])
            return
        raise RuntimeError(f"flow drive: {label} was not refused")

    run("issue Bank -> Alice", bank, CashIssueFlow(1000, "USD", alice.party, notary.party))
    run("pay Alice -> Bob", alice, CashPaymentFlow(400, "USD", bob.party))
    run("pay Bob -> Carol", bob, CashPaymentFlow(150, "USD", carol.party))
    run("pay Carol -> Bank", carol, CashPaymentFlow(50, "USD", bank.party))

    # a payment interrupted while it awaits the notary's answer
    n_calls = len(calls)
    fsm = alice.start_flow(CashPaymentFlow(100, "USD", carol.party))
    waiting = fsm.waiting
    if fsm.done or waiting is None or waiting[0] != "recv" or \
            alice.smm.sessions_by_id[waiting[1]][1].party != notary.party:
        raise RuntimeError(f"flow drive: the payment is not awaiting the notary ({waiting})")
    net.fabric.pump(1)               # the notary takes the request
    alice.smm.stop()
    alice.smm = StateMachineManager(alice.services, alice.messaging,
                                    rng=_random.Random(seed + 1))
    if alice.smm.restore_checkpoints() != 1:
        raise RuntimeError("flow drive: the interrupted payment did not restore")
    restored, = alice.smm.flows.values()
    net.run()
    record("pay Alice -> Carol (restored)", restored.result_or_throw(), n_calls)

    coin, = alice.vault.unconsumed_states(CashState)

    def spend_to(party):
        b = TransactionBuilder(notary.party)
        b.add_input_state(coin)
        b.add_output_state(coin.state.data.with_owner(party.owning_key), CASH_CONTRACT)
        b.add_command(CashMove(), alice.party.owning_key)
        return alice.services.sign_initial_transaction(b)

    good = spend_to(bob.party)
    sig = good.sigs[0]
    flipped = dataclasses.replace(good, sigs=(dataclasses.replace(
        sig, signature=bytes([sig.signature[0] ^ 1]) + sig.signature[1:]),))
    refused("flipped signature at finality", alice, FinalityFlow(flipped), InvalidSignature)
    refused("flipped signature at the notary", alice, NotaryFlow(flipped), NotaryException,
            "invalid-transaction")
    run("spend Alice -> Bob", alice, FinalityFlow(good))
    refused("double spend Alice -> Carol", alice, FinalityFlow(spend_to(carol.party)),
            NotaryException, "conflict")

    ledger["balances"] = {n.name: _cash_of(n) for n in (bank, alice, bob, carol)}
    want = {"Bank": 50, "Alice": 0, "Bob": 750, "Carol": 200}
    if ledger["balances"] != want:
        raise RuntimeError(f"flow drive: balances {ledger['balances']}, expected {want}")
    if sum(_cash_of(n) for n in net.nodes) != 1000:
        raise RuntimeError("flow drive: cash was created or destroyed")
    return ledger


def flow_flush(verifier, shards: int, seed: int = FLOW_SEED) -> dict:
    """Phase 8b: FLOW_PAYERS x FLOW_COINS CashPaymentFlows to one node,
    all started before one pump round, notarised by a batching notary
    with `shards` shards in one flush (one tick: one dispatch per shard
    that holds requests). The payers' issuance is recorded straight into
    the vaults (and the notary's and the recipient's stores) before the
    window. Raises unless every payment completes, the balances are
    exact, the notary did not degrade and, for shards > 1, the answers
    spread over more than one shard; returns the window's figures."""
    from corda_tpu_torch.core.contracts import Amount, Issued
    from corda_tpu_torch.core.identity import PartyAndReference
    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance import CashPaymentFlow
    from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashIssue, CashState
    from corda_tpu_torch.testing import MockNetwork

    kinds = (schemes.EDDSA_ED25519_SHA512, schemes.ECDSA_SECP256R1_SHA256,
             schemes.EDDSA_ED25519_SHA512, schemes.ECDSA_SECP256K1_SHA256)
    net = MockNetwork(seed=seed, batch_verifier=verifier)
    notary = net.create_notary("Notary", batching=True, shards=shards)
    bank = net.create_node("Bank")
    sink = net.create_node("Sink")
    payers = [net.create_node(f"Payer{i}", scheme_id=kinds[i % 4]) for i in range(FLOW_PAYERS)]
    token = Issued(PartyAndReference(bank.party, b"\x01"), "USD")
    for p in payers:
        b = TransactionBuilder(notary.party)
        for j in range(FLOW_COINS):
            b.add_output_state(CashState(Amount(100 + j, token), p.party.owning_key), CASH_CONTRACT)
        b.add_command(CashIssue(), bank.party.owning_key)
        issue = bank.services.sign_initial_transaction(b)
        for node in (p, notary, sink):
            node.services.record_transactions([issue])

    svc = notary.services.notary_service
    flushes = []
    tick = notary.ticks[0]

    def timed_tick():
        n_calls, t = len(verifier.calls), time.perf_counter()
        answered = tick()
        if answered:
            mine = verifier.calls[n_calls:]
            flushes.append({"answered": answered, "wall_s": time.perf_counter() - t,
                            "rows": sum(len(r) for r, _ in mine), "dispatches": len(mine),
                            "device_s": sum(pv.device_seconds() for _, pv in mine)})
        return answered

    notary.ticks[0] = timed_tick
    n_pay = FLOW_PAYERS * FLOW_COINS
    verifier.calls = []
    t0 = time.perf_counter()
    fsms = [p.start_flow(CashPaymentFlow(10, "USD", sink.party))
            for p in payers for _ in range(FLOW_COINS)]
    net.run()
    wall = time.perf_counter() - t0
    label = f"flow flush shards={shards}"
    for f in fsms:
        f.result_or_throw()
    if len(flushes) != 1 or flushes[0]["answered"] != n_pay:
        raise RuntimeError(f"{label}: {n_pay} payments answered in flushes {flushes}, not one")
    if svc.batches_dispatched != flushes[0]["dispatches"]:
        raise RuntimeError(f"{label}: {svc.batches_dispatched} notary dispatches counted")
    if _cash_of(sink) != 10 * n_pay or any(
            _cash_of(p) != sum(range(100, 100 + FLOW_COINS)) - 10 * FLOW_COINS for p in payers):
        raise RuntimeError(f"{label}: balances are not exact")
    if svc.degraded or svc.metrics.counter("Notary.DegradedFlushes").count:
        raise RuntimeError(f"{label}: the notary degraded: {svc.degraded_evidence}")
    answered = [svc.metrics.counter(f"Notary.Shard{k}.Answered").count for k in range(shards)]
    if shards > 1 and (sum(map(bool, answered)) < 2 or sum(answered) != n_pay):
        raise RuntimeError(f"{label}: answers per shard {answered}, not spread")
    flush = flushes[0]
    return {"payments": n_pay, "wall_s": wall, "flush": flush, "shard_answered": answered,
            "flow_calls": len(verifier.calls) - flush["dispatches"],
            "flow_rows": sum(len(r) for r, _ in verifier.calls) - flush["rows"],
            "flow_device_s": sum(pv.device_seconds() for _, pv in verifier.calls)
            - flush["device_s"]}


def phase_flows(device, card: str) -> dict:
    """Phase 8: drive 1 through the flows, the in-memory fabric and
    MockNetwork over CudaBatchVerifier on the card (8a), the batching
    notary under concurrent payments for shards 1 and 4 (8b), and 8a
    again over CpuBatchVerifier, whose ledger must equal the card's
    (8c). Returns the launches of 8a and 8b."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    verifier = _recording_verifier(FLOW_BATCHES, device)
    t_phase = time.perf_counter()
    _zero_counters()
    t0 = time.perf_counter()
    ledger = flow_drive(verifier)
    wall_a = time.perf_counter() - t0
    rows = [len(r) for r, _ in verifier.calls]
    device_s = sum(pv.device_seconds() for _, pv in verifier.calls)
    pays = {k: v for k, v in ledger["calls"].items() if k.startswith("pay")}
    print(f"flow drive (8a): {len(ledger['ids'])} flows completed and "
          f"{len(ledger['refused'])} refused in {wall_a:.3f} s = "
          f"{len(ledger['ids']) / wall_a:.3f} completed flows/s; {len(rows)} card verify calls, rows per "
          f"call {min(rows)}-{max(rows)} (mean {sum(rows) / len(rows):.2f}), chunk events "
          f"summed {device_s:.3f} s; card verify calls "
          f"per payment {json.dumps(pays)}; per flow {json.dumps(ledger['calls'])}; refused "
          f"{ledger['refused']}; balances {ledger['balances']}; {card}")
    for shards in FLOW_SHARDS:
        verifier.calls = []
        fl = flow_flush(verifier, shards)
        f = fl["flush"]
        print(f"flow flush (8b) shards={shards}: {fl['payments']} payments in {fl['wall_s']:.3f} s "
              f"= {fl['payments'] / fl['wall_s']:.3f} flows/s; notary flush {f['answered']} "
              f"answers, {f['dispatches']} dispatch(es), {f['rows']} rows, wall "
              f"{f['wall_s']:.3f} s (chunk events {f['device_s']:.3f} s); flow verify calls "
              f"{fl['flow_calls']} = {fl['flow_calls'] / fl['payments']:.2f} per payment, "
              f"{fl['flow_rows']} rows, chunk events summed {fl['flow_device_s']:.3f} s; "
              f"answered per shard {fl['shard_answered']}; {card}")
    launches = _read_counters()
    for kernel in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in the flow phase")
    t0 = time.perf_counter()
    cpu = flow_drive(CpuBatchVerifier())
    for key in ("ids", "notary_sigs", "refused", "balances"):
        if cpu[key] != ledger[key]:
            raise RuntimeError(f"flow drive: the card's {key} differ from CpuBatchVerifier's")
    print(f"flow drive (8c) over CpuBatchVerifier in {time.perf_counter() - t0:.3f} s: the same "
          f"{len(cpu['ids'])} transaction ids, notary signatures, refusals and balances")
    print(f"flow phase: launches {launches}; wall {time.perf_counter() - t_phase:.3f} s; {card}")
    return launches


POOL_WORKERS = 2
POOL_REQUESTS = 4096         # phase 9a/9b: the first phase-6 spends as requests (16,384, 8,192 cut)
POOL_WINDOW = 8192           # VerifierWorker's default ingest_window
POOL_INGEST_SHARDS = 4       # phase 9b's decode shards
POOL_SAMPLE = 256            # phase 9a: answers held against a CpuBatchVerifier worker
POOL_LOSS = 256              # phase 9c: requests when a worker is lost
POOL_CHUNK = 512             # phase 9d: spends per ingest batch


class _GcClock:
    """Seconds the interpreter spends in garbage collection while the
    clock is entered, and its collections per generation (gc.callbacks)."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = [0, 0, 0]
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def __str__(self):
        return f"gc {self.seconds:.3f} s in {self.collections} collections (gen 0/1/2)"


def _verdict(fut) -> str:
    """A pool future's answer: "ok", or its failure as `Type: message`."""
    if not fut.done:
        return "unanswered"
    try:
        fut.result()
    except Exception as e:   # noqa: BLE001 - the failure is the answer
        return f"{type(e).__name__}: {e}"
    return "ok"


def _check_pool_answers(answers, labels, label: str) -> None:
    """The worker's answers against the fixture's labels: an
    InvalidSignature failure exactly for the flipped signatures, success
    for the rest (no uniqueness or notary check runs in a worker)."""
    want_bad = "VerificationFailedError: InvalidSignature: "
    for i, (a, kind) in enumerate(zip(answers, labels)):
        if (a.startswith(want_bad) if kind == "invalid-signature" else a == "ok"):
            continue
        raise RuntimeError(f"{label}: request {i} ({kind}) answered {a!r}")


def _pool(verifier, window: int, ingest_shards: int = 0, clock=None, faults=None, policy=None):
    """A node endpoint with an OutOfProcessTransactionVerifierService and
    POOL_WORKERS VerifierWorkers sharing `verifier`, attached. Returns
    (network, service, workers, sizes): `sizes` gets the length of every
    request frame a worker's handler receives (a ring-fed worker's
    frames go to its ring instead)."""
    from corda_tpu_torch.node import messaging as msglib
    from corda_tpu_torch.node.verifier import (
        OutOfProcessTransactionVerifierService,
        VerifierWorker,
        request_ingest_pipeline,
    )

    net = msglib.InMemoryMessagingNetwork(clock=clock, faults=faults)
    sizes = []
    svc = OutOfProcessTransactionVerifierService(net.endpoint("Node"), clock=clock, policy=policy)
    workers = []
    for k in range(POOL_WORKERS):
        ep = net.endpoint(f"worker-{k}")
        ep.add_handler(msglib.TOPIC_VERIFIER_REQ, lambda msg: sizes.append(len(msg.payload)))
        workers.append(VerifierWorker(
            ep, "Node", batch_verifier=verifier, batch_window=window, clock=clock,
            heartbeat_micros=50_000 if clock else 0,
            ingest=request_ingest_pipeline(shards=ingest_shards) if ingest_shards else None))
    net.run()
    if svc.worker_count != POOL_WORKERS:
        raise RuntimeError(f"pool: {svc.worker_count} workers attached")
    return net, svc, workers, sizes


def pool_pass(verifier, ltxs, stxs, ingest_shards: int = 0) -> dict:
    """Phase 9a (9b with ingest shards): every (ltx, stx) through the
    pool, one drain per worker; returns the answers and the figures."""
    net, svc, workers, sizes = _pool(verifier, POOL_WINDOW, ingest_shards)
    _zero_counters()
    t0 = time.perf_counter()
    futs = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs, stxs)]
    t1 = time.perf_counter()
    net.run()
    t2 = time.perf_counter()
    drained = [w.drain() for w in workers]
    t3 = time.perf_counter()
    net.run()
    t4 = time.perf_counter()
    launches = _read_counters()
    answers = [_verdict(f) for f in futs]
    n = len(futs)
    batches = [w.metrics.histogram("Verifier.BatchSize") for w in workers]
    round_robin = [len(range(k, n, POOL_WORKERS)) for k in range(POOL_WORKERS)]
    if drained != round_robin or any(h.count != 1 for h in batches):
        raise RuntimeError(f"pool: drains took {drained} requests in "
                           f"{[h.count for h in batches]} dispatches, not one each")
    return {"answers": answers, "wall_s": t4 - t0, "send_s": t1 - t0, "deliver_s": t2 - t1,
            "drain_s": t3 - t2, "answer_s": t4 - t3, "launches": launches,
            "drains": [dict(w.drain_seconds[-1]) for w in workers],
            "rows": [int(h.max) for h in batches],
            "request_bytes": sum(sizes) / len(sizes) if sizes else None,
            "pipelines": [w._ingest for w in workers]}


def pool_loss(verifier, ltxs, stxs) -> dict:
    """Phase 9c: a worker lost with its half of the requests received and
    unanswered; on a TestClock its lease expires and its nonces
    re-dispatch to the survivor. Raises unless every future is answered
    exactly once, all by the survivor; returns the answers and figures."""
    from corda_tpu_torch.node.messaging import FabricFaults
    from corda_tpu_torch.node.services import TestClock
    from corda_tpu_torch.node.verifier import RedispatchPolicy

    clock = TestClock()
    faults = FabricFaults(clock)
    policy = RedispatchPolicy(lease_micros=100_000, request_timeout_micros=100_000_000,
                              backoff_base_micros=50_000, backoff_cap_micros=200_000)
    net, svc, (lost, survivor), _ = _pool(verifier, POOL_WINDOW, clock=clock, faults=faults,
                                          policy=policy)
    t0 = time.perf_counter()
    futs = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs, stxs)]
    net.run()                    # both workers hold their halves
    faults.kill("worker-0")      # lost mid-batch: received, never answered
    net.endpoint("worker-0").running = False
    survivor.drain()
    net.run()
    clock.advance(150_000)
    survivor.drain()             # its heartbeat renews its lease
    net.run()
    svc.tick()                   # worker-0's lease expired: detached
    clock.advance(80_000)        # past the jittered backoff
    svc.tick()                   # re-dispatch to the survivor
    net.run()
    survivor.drain()
    net.run()
    wall = time.perf_counter() - t0
    answers = [_verdict(f) for f in futs]
    m = svc.metrics
    answered = (m.meter("TransactionVerifierService.Verification.Success").count
                + m.meter("TransactionVerifierService.Verification.Failure").count)
    by_worker = [w.metrics.meter("Verifier.Verified").count
                 + w.metrics.meter("Verifier.Failed").count for w in (lost, survivor)]
    redispatched = m.meter("Verifier.Redispatched").count
    label = "pool worker loss (9c)"
    if "unanswered" in answers or answered != len(futs) or svc.in_flight:
        raise RuntimeError(f"{label}: {answers.count('unanswered')} unanswered, {answered} "
                           f"answers accepted for {len(futs)} requests")
    if by_worker != [0, len(futs)] or redispatched == 0 or svc.worker_count != 1:
        raise RuntimeError(f"{label}: answered per worker {by_worker}, redispatched "
                           f"{redispatched}, {svc.worker_count} workers left")
    return {"answers": answers, "wall_s": wall, "redispatched": redispatched,
            "lost": m.meter("Verifier.WorkersLost").count,
            "survivor_drains": len(survivor.drain_seconds)}


def ring_flush(fx, hub, shards: int = 1) -> tuple:
    """Phase 9d: the wire bytes of every spend naming this notary fed by
    an IngestPipeline, from its own thread, into a batching notary's
    ring, then one flush. The ring path checks no notary, so the spends
    naming another notary go through `process`, as a flow's request
    does. Returns (svc, answers, wall seconds, pipeline)."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.flows.api import FlowFuture
    from corda_tpu_torch.node.ingest import IngestPipeline
    from corda_tpu_torch.node.notary import (
        BatchingNotaryService,
        InMemoryUniquenessProvider,
        ShardedUniquenessProvider,
        _PendingNotarisation,
        finish_process,
        run_process,
    )

    n = len(fx.spends)
    uniq = ShardedUniquenessProvider(shards) if shards > 1 else InMemoryUniquenessProvider()
    svc = BatchingNotaryService(hub, uniq, max_batch=n, shards=shards, shard_queue_depth=n,
                                degraded_fallback=False)
    mine = [i for i, stx in enumerate(fx.spends) if stx.wtx.notary == svc.identity]
    others = sorted(set(range(n)) - set(mine))
    wire = [ser.encode(fx.spends[i]) for i in mine]
    batches = [wire[k : k + POOL_CHUNK] for k in range(0, len(wire), POOL_CHUNK)]
    pipe = IngestPipeline(ring_depth=len(batches))    # one flush takes every batch
    svc.attach_ingest(pipe.ring)
    futs, errors = [], []

    def wrap(entries):
        batch = []
        for e in entries:
            if e.error is not None:
                errors.append(e.error)
                continue
            fut = FlowFuture()
            futs.append(fut)
            batch.append(_PendingNotarisation(e.stx, fx.requester, fut))
        return batch

    t0 = time.perf_counter()
    feeder = pipe.feed(batches, wrap=wrap)
    started = run_process([svc.process(fx.spends[i], fx.requester) for i in others])
    feeder.join()
    dispatched = svc.batches_dispatched
    svc.flush()
    answers = [None] * n
    for i, a in zip(others, finish_process(started)):
        answers[i] = a
    for i, fut in zip(mine, futs):
        answers[i] = fut.result()
    wall = time.perf_counter() - t0
    pipe.close()
    if errors or len(futs) != len(mine) or svc.batches_dispatched - dispatched != shards:
        raise RuntimeError(f"ring flush: {svc.batches_dispatched - dispatched} dispatches for "
                           f"{len(futs)} of {len(mine)} fed spends, ingest errors {errors[:2]}")
    return svc, answers, wall, pipe


def id_stage(fx, card: str) -> None:
    """The ingest's batched Merkle-id stage (`install_tx_ids`) on fresh
    decodes of every spend: with the leaf and root caches an
    IngestPipeline starts with, without caches, and the native
    per-transaction id walk (`wtx.id`). Two rounds in that order;
    every run's ids must equal the spends'. Prints microseconds per
    transaction, the garbage collection inside each run and the share
    of distinct component leaves."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.node import ingest

    wtxs = [ser.decode(ser.encode(stx)).wtx for stx in fx.spends]
    want = [stx.id for stx in fx.spends]
    leaves = [p for w in wtxs for p in w.leaf_preimages()]
    runs = {
        "cached": lambda: ingest.install_tx_ids(
            wtxs, ingest.DigestCache(ingest.LEAF_CACHE_SIZE),
            ingest.DigestCache(ingest.ROOT_CACHE_SIZE)),
        "uncached": lambda: ingest.install_tx_ids(wtxs, None, None),
        "walk": lambda: [w.id for w in wtxs],
    }
    us = {k: [] for k in runs}
    gcs = {k: [] for k in runs}
    for _ in range(2):
        for name, run in runs.items():
            for w in wtxs:
                object.__setattr__(w, "_id_cache", None)
            with _GcClock() as clock:
                t0 = time.perf_counter()
                run()
                us[name].append(round((time.perf_counter() - t0) * 1e6 / len(wtxs), 3))
            gcs[name].append(f"{clock.seconds:.3f} s/{clock.collections[2]}")
            if [w.__dict__["_id_cache"] for w in wtxs] != want:
                raise RuntimeError(f"id stage: {name} gives other ids than the spends'")
    print(f"id stage: {len(wtxs)} transactions, {len(leaves) / len(wtxs):.2f} leaves each, "
          f"{len(set(leaves)) / len(leaves):.4f} of them distinct; us per transaction (two "
          f"rounds) install_tx_ids with caches {us['cached']}, without {us['uncached']}, native "
          f"id walk {us['walk']}; gc seconds/gen-2 collections in each run: with caches "
          f"{gcs['cached']}, without {gcs['uncached']}, walk {gcs['walk']}; {card}")


def phase_pool(device, card: str, fx) -> dict:
    """Phase 9 (module docstring); returns the launches of 9a-9d."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import notary_hub

    verifier = _recording_verifier((CHUNK,), device)
    hub = notary_hub(fx, verifier)
    t0 = time.perf_counter()
    spends, labels = fx.spends[:POOL_REQUESTS], fx.labels[:POOL_REQUESTS]
    ltxs = [stx.to_ledger_transaction(hub) for stx in spends]
    print(f"pool: {len(ltxs)} ledger transactions resolved in {time.perf_counter() - t0:.3f} s")
    launches = {}
    results = {}
    for tag, shards in (("9a", 0), ("9b", POOL_INGEST_SHARDS)):
        label = f"pool ({tag}" + (f", ingest shards={shards})" if shards else ")")
        verifier.calls = []
        with _GcClock() as gc_clock:
            r = pool_pass(verifier, ltxs, spends, shards)
        _check_pool_answers(r["answers"], labels, label)
        for kernel in ("ed_ladder", "wei_ladder_windowed"):
            if r["launches"][kernel] == 0:
                raise RuntimeError(f"{kernel} was not launched in the {label} drains")
        if [len(rs) for rs, _ in verifier.calls] != r["rows"]:
            raise RuntimeError(f"{label}: dispatches of {[len(rs) for rs, _ in verifier.calls]} "
                               f"rows, BatchSize {r['rows']}")
        n = len(ltxs)
        frames = (f"{r['request_bytes']:.1f} frame bytes per request"
                  if r["request_bytes"] is not None else "request frames to the workers' rings")
        print(f"{label}: {n} requests in {r['wall_s']:.3f} s = {n / r['wall_s']:.1f} verified "
              f"transactions/s (send {r['send_s']:.3f}, deliver {r['deliver_s']:.3f}, drains "
              f"{r['drain_s']:.3f}, answers {r['answer_s']:.3f} s; {gc_clock}); {frames}; rows "
              f"per dispatch {r['rows']}; launches {r['launches']}; {card}")
        for k, d in enumerate(r["drains"]):
            print(f"{label} worker-{k} drain: {d['requests']} requests, {d['rows']} rows, decode "
                  f"{d['decode']:.3f} s, dispatch {d['dispatch']:.3f} s, contract "
                  f"{d['contract']:.3f} s, answer {d['answer']:.3f} s; {card}")
        if shards:
            pipes = r["pipelines"]
            stages = {k: round(sum(p.stage_seconds[k] for p in pipes), 6)
                      for k in pipes[0].stage_seconds}
            print(f"{label} pipeline stage seconds (both workers): {json.dumps(stages)}; "
                  f"frame-cache hits {sum(p.frame_hits for p in pipes)}")
            for p in pipes:
                p.close()
            if r["answers"] != results["9a"]["answers"]:
                raise RuntimeError(f"{label}: answers differ from 9a's")
        results[tag] = r
        launches[tag] = r["launches"]

    id_stage(fx, card)

    import random as _random

    sample = sorted(_random.Random(POOL_SAMPLE).sample(range(len(ltxs)),
                                                       min(POOL_SAMPLE, len(ltxs))))
    cpu = pool_pass(CpuBatchVerifier(), [ltxs[i] for i in sample],
                    [spends[i] for i in sample])
    if cpu["answers"] != [results["9a"]["answers"][i] for i in sample]:
        raise RuntimeError("pool (9a): the card's answers differ from a CpuBatchVerifier worker's")
    print(f"pool (9a): {len(sample)} sampled answers equal a CpuBatchVerifier worker's")

    k = min(POOL_LOSS, len(ltxs))
    _zero_counters()
    loss = pool_loss(verifier, ltxs[:k], spends[:k])
    launches["9c"] = _read_counters()
    _check_pool_answers(loss["answers"], labels[:k], "pool worker loss (9c)")
    if launches["9c"]["ed_ladder"] == 0:
        raise RuntimeError("ed_ladder was not launched by the surviving worker (9c)")
    print(f"pool worker loss (9c): {k} requests answered exactly once by the survivor in "
          f"{loss['wall_s']:.3f} s; workers lost {loss['lost']}, redispatched "
          f"{loss['redispatched']}, survivor drains {loss['survivor_drains']}; launches "
          f"{launches['9c']}; {card}")

    verifier.calls = []
    _zero_counters()
    with _GcClock() as gc_clock:
        svc, answers, wall, pipe = ring_flush(fx, hub)
    launches["9d"] = _read_counters()
    disp = _check_notary(fx, svc, answers, verifier.calls, "ring-fed notary (9d)")
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches["9d"][kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched on the ring-fed notary flush (9d)")
    n = len(fx.spends)
    stages = {k: round(v, 6) for k, v in pipe.stage_seconds.items()}
    print(f"ring-fed notary (9d): {n} spends fed and flushed in {wall:.3f} s = "
          f"{n / wall:.1f} notarisations/s, every answer its label ({gc_clock}); pipeline "
          f"stage seconds "
          f"{json.dumps(stages)}, frame-cache hits {pipe.frame_hits}; flush phase_seconds "
          f"{json.dumps({k: round(v, 6) for k, v in (svc.phase_seconds or {}).items()})}; "
          f"{disp['rows']} rows in {len(verifier.calls)} dispatch(es), device (chunk events) "
          f"{disp['device_s']:.3f} s; launches {launches['9d']}; {card}")
    print(f"pool phase launches: {json.dumps(launches)}")
    return launches


# -- phase 10: persistence, the vault query DSL, the Raft and BFT clusters ---

CLUSTER_SEED = 13
CLUSTER_BATCHES = (128, 4096)
RAFT_MEMBERS = 3             # the notary demo's Raft cluster
BFT_REPLICAS = 4             # the notary demo's BFT cluster: f = 1
RAFT_ENTRIES = 4096          # phase 10c: 4 snapshots at the reference's interval of 1,024 (16,384 cut)
DURABLE_FLUSH = 4096         # phase 10a: the first phase-6 spends per durable flush (16,384, 8,192 cut)
DURABLE_REOPEN = 256         # phase 10a: double spends sent to the reopened database


def _committed_count(uniqueness) -> int:
    count = getattr(uniqueness, "committed_count", None)
    return count if count is not None else len(uniqueness.committed)


def _same_ledger(card: dict, cpu: dict, label: str) -> None:
    for key in ("ids", "notary_sigs", "refused", "balances", "leaders"):
        if card[key] != cpu[key]:
            raise RuntimeError(f"{label}: the card's {key} differ from CpuBatchVerifier's")


def _timed_database(path: str):
    """A NodeDatabase that sums the seconds spent in sqlite (every
    outermost transaction, its COMMIT included, and every bare query: the
    uniqueness providers' calls) into `.seconds`."""
    from corda_tpu_torch.node.persistence import NodeDatabase

    class TimedDatabase(NodeDatabase):
        seconds = 0.0

        def _timed(self, fn, *args):
            if self._tx_depth:
                return fn(*args)
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.seconds += time.perf_counter() - t0

        def query(self, sql, params=()):
            return self._timed(super().query, sql, params)

        def transaction(self):
            db, tx = self, super().transaction()

            class Timed:
                def __enter__(self):
                    self.t0 = time.perf_counter() if not db._tx_depth else None
                    return tx.__enter__()

                def __exit__(self, *exc):
                    try:
                        return tx.__exit__(*exc)
                    finally:
                        if self.t0 is not None:
                            db.seconds += time.perf_counter() - self.t0

            return Timed()

    return TimedDatabase(path)


def _durable_provider(db, shards: int):
    from corda_tpu_torch.node.persistence import (
        PersistentUniquenessProvider,
        ShardedPersistentUniquenessProvider,
    )

    return ShardedPersistentUniquenessProvider(db, shards) if shards > 1 \
        else PersistentUniquenessProvider(db)


def _durable_notary(hub, uniqueness, shards: int, depth: int):
    from corda_tpu_torch.node.notary import BatchingNotaryService

    return BatchingNotaryService(hub, uniqueness, max_batch=depth, shards=shards,
                                 shard_workers=False, shard_queue_depth=depth,
                                 degraded_fallback=False)


def _double_spends(fx, picks) -> list:
    """For each picked accepted spend, a new transaction spending its
    input to another output, signed by the fixture's key for it."""
    from corda_tpu_torch.core.contracts import StateAndRef
    from corda_tpu_torch.core.transactions import SignedTransaction, TransactionBuilder
    from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashMove
    from corda_tpu_torch.testing.notary_fixture import _signature

    issued = {issue.id: issue for issue in fx.issues}
    out = []
    for i in picks:
        ref = fx.spends[i].wtx.inputs[0]
        sar = StateAndRef(issued[ref.txhash].wtx.outputs[ref.index], ref)
        sb = TransactionBuilder()
        sb.add_input_state(sar)
        sb.add_output_state(sar.state.data.with_owner(fx.requester.owning_key), CASH_CONTRACT)
        sb.add_command(CashMove(), fx.owners[i].public)
        wtx = sb.to_wire_transaction()
        out.append(SignedTransaction(wtx, (_signature(fx.owners[i], wtx.id),)))
    return out


def durable_flush(fx, hub, wire, verifier, shards: int, path: str, card: str) -> dict:
    """Phase 10a for one shard count: the phase-6 flush over an on-disk
    uniqueness store (a fresh database, a fresh decode), held to phase
    6's checks; then the database closed, reopened under a new provider
    and notary, and DURABLE_REOPEN new spends of accepted spends' inputs
    sent to it: each must be answered "conflict", naming the committed
    spend."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.node.notary import finish_process, run_process
    from corda_tpu_torch.testing.notary_fixture import answer_kind

    label = f"durable notary (10a) shards={shards}"
    db = _timed_database(path)
    svc = _durable_notary(hub, _durable_provider(db, shards), shards, len(wire))
    verifier.calls = []
    received = [ser.decode(b) for b in wire]
    t0 = time.perf_counter()
    started = run_process([svc.process(stx, fx.requester) for stx in received])
    t1 = time.perf_counter()
    svc.flush()
    t2 = time.perf_counter()
    answers = finish_process(started)
    wall = time.perf_counter() - t0
    disp = _check_notary(fx, svc, answers, verifier.calls, label)
    n = len(wire)
    phases = {k: round(v, 6) for k, v in (svc.phase_seconds or {}).items()}
    print(f"{label}: {n} spends in {wall:.3f} s = {n / wall:.1f} notarisations/s (intake "
          f"{t1 - t0:.3f} s, flush {t2 - t1:.3f} s; in sqlite {db.seconds:.3f} s, "
          f"{db.seconds / wall:.1%} of the window); {card}")
    print(f"{label} phase_seconds: {json.dumps(phases)}; dispatch {len(verifier.calls)} calls, "
          f"{disp['rows']} rows, device (chunk events) {disp['device_s']:.3f} s; {card}")
    db.close()

    accepted = [i for i, want in enumerate(fx.labels) if want == "ok"]
    picks = sorted(random.Random(shards).sample(accepted, min(DURABLE_REOPEN, len(accepted))))
    again = _double_spends(fx, picks)
    t3 = time.perf_counter()
    db = _timed_database(path)
    uniqueness = _durable_provider(db, shards)
    if _committed_count(uniqueness) != len(accepted):
        raise RuntimeError(f"{label}: {_committed_count(uniqueness)} inputs committed on the "
                           f"reopened database, {len(accepted)} accepted")
    svc = _durable_notary(hub, uniqueness, shards, len(again))
    started = run_process([svc.process(stx, fx.requester) for stx in again])
    svc.flush()
    answers = finish_process(started)
    reopen = time.perf_counter() - t3
    for i, a in zip(picks, answers):
        if answer_kind(a) != "conflict" or list(a.conflict.values()) != [fx.spends[i].id]:
            raise RuntimeError(f"{label}: the reopened notary answered spend {i}'s double "
                               f"spend with {a!r}")
    if _committed_count(uniqueness) != len(accepted):
        raise RuntimeError(f"{label}: a refused double spend was committed")
    db.close()
    print(f"{label} reopened: {len(accepted)} committed inputs read back; {len(again)} double "
          f"spends answered conflict, each naming its committed spend, in {reopen:.3f} s; "
          f"{card}")
    return {"rate": n / wall, "wall_s": wall, "sqlite_s": db.seconds}


def _settle(net, done, rounds: int = 400, advance: int = 20_000) -> None:
    """run() and advance the clock until done() (the reference's settle:
    consensus needs time)."""
    for _ in range(rounds):
        net.run()
        if done():
            return
        net.clock.advance(advance)
    raise RuntimeError("the cluster did not settle")


def _flow_runner(net, calls, ledger: dict, notary_key):
    """run(label, node, logic) and refused(label, node, logic, kind) over a
    cluster: each flow settled, its transaction id, the cluster's
    signatures and the card calls it made recorded in `ledger`."""
    from corda_tpu_torch.node.notary import NotaryException

    def run(label, node, logic, rounds=400):
        n_calls = len(calls)
        fsm = node.start_flow(logic)
        _settle(net, lambda: fsm.done, rounds)
        stx = fsm.result_or_throw()
        ledger["ids"].append(str(stx.id))
        ledger["notary_sigs"].append(sorted(s.signature.hex() for s in stx.sigs
                                            if s.by in notary_key))
        ledger["calls"][label] = len(calls) - n_calls
        return stx

    def refused(label, node, logic, kind):
        fsm = node.start_flow(logic)
        _settle(net, lambda: fsm.done)
        try:
            fsm.result_or_throw()
        except NotaryException as e:
            if e.error.kind != kind:
                raise RuntimeError(f"{label} refused as {e.error.kind!r}, not {kind!r}") from e
            ledger["refused"].append([label, e.error.kind])
            return e.error
        raise RuntimeError(f"{label} was not refused")

    return run, refused


def _spend(node, coin, notary, owner):
    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashMove

    b = TransactionBuilder(notary)
    b.add_input_state(coin)
    b.add_output_state(coin.state.data.with_owner(owner.owning_key), CASH_CONTRACT)
    b.add_command(CashMove(), node.party.owning_key)
    return node.services.sign_initial_transaction(b)


def _stop(net, node) -> None:
    """Stop a cluster member the way the reference's tests do: its
    protocol, its state machine and its endpoint."""
    (getattr(node, "raft", None) or node.bft).stop()
    node.smm.stop()
    net.fabric.endpoint(node.name).running = False


def _maps_equal(maps, label: str) -> None:
    if any(m != maps[0] for m in maps[1:]):
        raise RuntimeError(f"{label}: the live members' committed maps differ "
                           f"({[len(m) for m in maps]} refs)")


def raft_drive(verifier, db_dir: str, seed: int = CLUSTER_SEED) -> dict:
    """Phase 10b: a validating Raft notary cluster of RAFT_MEMBERS
    persistent members, elected; Bank (ed25519) issues to Alice (p256);
    Alice pays Bob (secp256k1), Bob pays Carol (ed25519; a backchain),
    Carol pays Bank (a backchain); a double spend is
    refused "conflict" with every member's map holding the first spend;
    the leader is stopped, the survivors elect, and Carol pays Bob under
    the new leader. Raises unless every outcome, balance and live map
    agrees; returns the ledger and the network."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.flows.core_flows import FinalityFlow
    from corda_tpu_torch.node.raft import LEADER
    from corda_tpu_torch.testing import MockNetwork

    calls = getattr(verifier, "calls", [])
    net = MockNetwork(seed=seed, db_dir=db_dir, batch_verifier=verifier)
    service, members = net.create_raft_notary_cluster(RAFT_MEMBERS, validating=True)
    bank = net.create_node("Bank")
    alice = net.create_node("Alice", scheme_id=schemes.ECDSA_SECP256R1_SHA256)
    bob = net.create_node("Bob", scheme_id=schemes.ECDSA_SECP256K1_SHA256)
    carol = net.create_node("Carol")
    first_leader = net.elect(members)
    ledger = {"ids": [], "notary_sigs": [], "refused": [], "calls": {}}
    run, refused = _flow_runner(net, calls, ledger, {service.owning_key})
    t0 = time.perf_counter()
    run("issue Bank -> Alice", bank, CashIssueFlow(1000, "USD", alice.party, service))
    run("pay Alice -> Bob", alice, CashPaymentFlow(400, "USD", bob.party))
    run("pay Bob -> Carol", bob, CashPaymentFlow(150, "USD", carol.party))
    run("pay Carol -> Bank", carol, CashPaymentFlow(50, "USD", bank.party))
    coin, = alice.vault.unconsumed_states(CashState)
    good = run("spend Alice -> Carol", alice, FinalityFlow(_spend(alice, coin, service, carol.party)))
    err = refused("double spend Alice -> Bob", alice,
                  FinalityFlow(_spend(alice, coin, service, bob.party)), "conflict")
    if [str(v) for v in err.conflict.values()] != [str(good.id)]:
        raise RuntimeError(f"raft drive: the double spend lost to {err.conflict}")
    _settle(net, lambda: len({m.raft.last_applied for m in members}) == 1)
    maps = [m.services.notary_service.uniqueness.committed for m in members]
    _maps_equal(maps, "raft drive")
    if maps[0].get(coin.ref) != good.id:
        raise RuntimeError("raft drive: the cluster's map does not hold the first spend")
    leader = next(m for m in members if m.raft.role == LEADER)
    _stop(net, leader)
    survivors = [m for m in members if m is not leader]
    new_leader = net.elect(survivors)
    run("pay Carol -> Bob (new leader)", carol, CashPaymentFlow(100, "USD", bob.party))
    wall = time.perf_counter() - t0
    _settle(net, lambda: len({m.raft.last_applied for m in survivors}) == 1)
    _maps_equal([m.services.notary_service.uniqueness.committed for m in survivors],
                "raft drive after the leader stopped")
    ledger["balances"] = {n.name: _cash_of(n) for n in (bank, alice, bob, carol)}
    want = {"Bank": 50, "Alice": 0, "Bob": 350, "Carol": 600}
    if ledger["balances"] != want:
        raise RuntimeError(f"raft drive: balances {ledger['balances']}, expected {want}")
    ledger["leaders"] = [first_leader.name, leader.name, new_leader.name]
    return {"ledger": ledger, "net": net, "members": members, "stopped": leader,
            "leader": new_leader, "nodes": (bank, alice, bob, carol), "wall_s": wall,
            "service": service}


def raft_transfer(drive: dict, entries: int, card: str, seed: int = CLUSTER_SEED) -> dict:
    """Phase 10c: `entries` distinct single-input commits through the
    elected leader's RaftUniquenessProvider.commit_async, one per pump
    round, while the member stopped in 10b is down (the leader snapshots
    and compacts every 1,024); then that member is rebuilt over its own
    database with rebuild_cluster_member: the leader's InstallSnapshot
    chunks and a log replay must restore it, its map equal to the
    leader's with every committed ref."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.core.contracts import StateRef
    from corda_tpu_torch.crypto.hashes import SecureHash
    from corda_tpu_torch.node.raft import AppendEntries, InstallSnapshot

    net, leader, dead = drive["net"], drive["leader"], drive["stopped"]
    requester = drive["nodes"][0].party
    provider = leader.services.notary_service.uniqueness
    rng = random.Random(seed)
    refs, futs = [], []
    t0 = time.perf_counter()
    for _ in range(entries):
        ref = StateRef(SecureHash(rng.randbytes(32)), rng.randrange(64))
        refs.append(ref)
        futs.append(provider.commit_async([ref], SecureHash(rng.randbytes(32)), requester))
        net.run()
    commit_s = time.perf_counter() - t0
    if not all(f.done and f.result() is None for f in futs):
        raise RuntimeError("raft transfer (10c): a commit did not complete")
    snapshots = leader.raft.snap_index // leader.raft.config.snapshot_interval
    frames = {"install": 0, "install_bytes": 0, "append_entries": 0}
    enqueue = net.fabric._enqueue

    def watching(msg, target):
        if target == dead.name and msg.topic.startswith("raft"):
            m = ser.decode(msg.payload)
            if isinstance(m, InstallSnapshot):
                frames["install"] += 1
                frames["install_bytes"] += len(m.data)
            elif isinstance(m, AppendEntries) and m.entries:
                frames["append_entries"] += len(m.entries)
        enqueue(msg, target)

    net.fabric._enqueue = watching
    t1 = time.perf_counter()
    net.fabric.endpoint(dead.name).running = True
    dead.rebuild_cluster_member()
    target = leader.raft.last_log_index
    _settle(net, lambda: dead.raft.last_applied >= target)
    transfer_s = time.perf_counter() - t1
    net.fabric._enqueue = enqueue
    got = dead.services.notary_service.uniqueness.committed
    want = provider.committed
    if got != want or any(want.get(r) is None for r in refs):
        raise RuntimeError(f"raft transfer (10c): the rebuilt member holds {len(got)} refs, "
                           f"the leader {len(want)}")
    if not frames["install"] or not frames["append_entries"]:
        raise RuntimeError(f"raft transfer (10c): not restored by InstallSnapshot and a log "
                           f"replay: {frames}")
    print(f"raft transfer (10c): {entries} commits through the leader in {commit_s:.3f} s = "
          f"{entries / commit_s:.1f} commits/s, {snapshots} snapshots (snap_index "
          f"{leader.raft.snap_index}); {dead.name} rebuilt and restored in {transfer_s:.3f} s "
          f"by {frames['install']} InstallSnapshot chunks ({frames['install_bytes']} snapshot "
          f"bytes) and a replay of {frames['append_entries']} entries; maps equal at "
          f"{len(got)} refs; {card}")
    return {"commit_s": commit_s, "transfer_s": transfer_s, **frames}


def bft_drive(net, calls, card: str) -> dict:
    """Phase 10d on 10b's network: a BFT notary cluster of BFT_REPLICAS
    (composite service key, threshold f + 1); Bank issues to Dave (p256),
    Dave pays Erin (ed25519) twice, each answer's replica signatures
    checked against the composite key; a double spend is refused
    "conflict"; a replica that is not the primary is stopped and Erin
    pays Dave; the replica is rebuilt and must catch up by state transfer
    while Erin pays Dave again; then the primary is stopped and, after
    the view change, Dave pays Erin. Raises unless every outcome, balance
    and live map agrees."""
    from corda_tpu_torch.crypto import composite as comp
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.flows.core_flows import FinalityFlow
    from corda_tpu_torch.utils.metrics import MetricRegistry

    party, members = net.create_bft_notary_cluster(BFT_REPLICAS,
                                                   metrics_factory=lambda _: MetricRegistry())
    bank = next(n for n in net.nodes if n.name == "Bank")
    dave = net.create_node("Dave", scheme_id=schemes.ECDSA_SECP256R1_SHA256)
    erin = net.create_node("Erin")
    leaves = set(party.owning_key.leaf_keys())
    ledger = {"ids": [], "notary_sigs": [], "refused": [], "calls": {}}
    run, refused = _flow_runner(net, calls, ledger, leaves)

    def paid(label, node, logic, rounds=600):
        stx = run(label, node, logic, rounds)
        sigs = {s.by for s in stx.sigs if s.by in leaves}
        if len(sigs) < 2 or not comp.is_fulfilled_by(party.owning_key, sigs):
            raise RuntimeError(f"bft drive: {label} carries {len(sigs)} replica signatures")
        return stx

    t0 = time.perf_counter()
    run("issue Bank -> Dave", bank, CashIssueFlow(500, "USD", dave.party, party))
    paid("pay Dave -> Erin", dave, CashPaymentFlow(200, "USD", erin.party))
    paid("pay Dave -> Erin (2)", dave, CashPaymentFlow(100, "USD", erin.party))
    coin, = dave.vault.unconsumed_states(CashState)
    good = paid("spend Dave -> Erin", dave, FinalityFlow(_spend(dave, coin, party, erin.party)))
    err = refused("double spend Dave -> Bank", dave,
                  FinalityFlow(_spend(dave, coin, party, bank.party)), "conflict")
    if [str(v) for v in err.conflict.values()] != [str(good.id)]:
        raise RuntimeError(f"bft drive: the double spend lost to {err.conflict}")
    primary = next(m for m in members if m.bft.is_primary)
    down = next(m for m in reversed(members) if m is not primary)
    _stop(net, down)
    paid("pay Erin -> Dave (replica down)", erin, CashPaymentFlow(100, "USD", dave.party))
    net.fabric.endpoint(down.name).running = True
    down.rebuild_cluster_member()
    paid("pay Erin -> Dave (replica rebuilt)", erin, CashPaymentFlow(50, "USD", dave.party))
    _settle(net, lambda: down.bft.exec_seq == primary.bft.exec_seq, advance=100_000)
    caught_up = down.bft.metrics.timer("Bft.Phase.CatchUp").count
    if not caught_up:
        raise RuntimeError("bft drive: the rebuilt replica did not catch up by state transfer")
    _maps_equal([m.services.notary_service.committed for m in members], "bft drive (rebuilt)")
    _stop(net, primary)
    live = [m for m in members if m is not primary]
    paid("pay Dave -> Erin (view change)", dave, CashPaymentFlow(25, "USD", erin.party),
         rounds=1200)
    wall = time.perf_counter() - t0
    if not all(m.bft.view > 0 for m in live):
        raise RuntimeError("bft drive: no view change after the primary stopped")
    _maps_equal([m.services.notary_service.committed for m in live], "bft drive (view change)")
    balances = {n.name: _cash_of(n) for n in (dave, erin)}
    if balances != {"Dave": 125, "Erin": 375}:
        raise RuntimeError(f"bft drive: balances {balances}")
    print(f"bft drive (10d): {len(ledger['ids'])} flows completed and {len(ledger['refused'])} "
          f"refused in {wall:.3f} s = {len(ledger['ids']) / wall:.3f} flows/s; every answer "
          f"{len(leaves)}-replica composite, threshold 2, fulfilled; {down.name} stopped, "
          f"rebuilt and caught up by state transfer ({caught_up} catch-up(s)); {primary.name} "
          f"stopped, views now {sorted({m.bft.view for m in live})}; card verify calls per flow "
          f"{json.dumps(ledger['calls'])}; balances {balances}; {card}")
    return {"wall_s": wall, "flows": len(ledger["ids"])}


def crash_drive(verifier, db_dir: str | None, seed: int = CLUSTER_SEED) -> dict:
    """Phase 10e: a validating notary, Bank (ed25519) and Alice (p256);
    Bank issues to Alice, Alice pays Bank. With a database (`db_dir`),
    Alice's vault page is read, a payment of Alice's is interrupted after
    its first frame, Alice is restarted with restart_node (her page must
    equal the one before) and the restored payment must finish; then the
    notary is restarted and must refuse a double spend of a state it
    committed before. Returns the page (and the refusal)."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.flows.core_flows import FinalityFlow
    from corda_tpu_torch.node.notary import NotaryException
    from corda_tpu_torch.node.vault_query import VaultQueryCriteria
    from corda_tpu_torch.testing import MockNetwork

    net = MockNetwork(seed=seed, db_dir=db_dir, batch_verifier=verifier)
    notary = net.create_notary("Notary", validating=True)
    bank = net.create_node("Bank")
    alice = net.create_node("Alice", scheme_id=schemes.ECDSA_SECP256R1_SHA256)
    bank.run_flow(CashIssueFlow(1000, "USD", alice.party, notary.party))
    pay = alice.run_flow(CashPaymentFlow(300, "USD", bank.party))

    def page(node):
        p = node.vault.query_by(VaultQueryCriteria())
        return [ser.encode(list(p.states)), p.total_states_available]

    out = {"page": page(alice)}
    if db_dir is None:
        return out
    fsm = alice.start_flow(CashPaymentFlow(100, "USD", bank.party))
    net.fabric.pump(1)
    if fsm.done or len(alice.services.checkpoint_storage.all()) != 1:
        raise RuntimeError("crash drive (10e): the payment is not checkpointed mid-flow")
    alice = net.restart_node(alice)
    if page(alice) != out["page"]:
        raise RuntimeError("crash drive (10e): Alice's vault page differs after the restart")
    restored, = alice.smm.flows.values()
    net.run()
    restored.result_or_throw()
    if (_cash_of(alice), _cash_of(bank)) != (600, 400):
        raise RuntimeError(f"crash drive (10e): balances {_cash_of(alice)} / {_cash_of(bank)}")
    notary = net.restart_node(notary)
    spent = next(s for s in alice.vault.consumed_states(CashState)
                 if s.ref in pay.wtx.inputs)
    try:
        alice.run_flow(FinalityFlow(_spend(alice, spent, notary.party, alice.party)))
    except NotaryException as e:
        if e.error.kind != "conflict" or list(e.error.conflict.values()) != [pay.id]:
            raise RuntimeError(f"crash drive (10e): the restarted notary answered {e.error}")
        out["refused"] = e.error.kind
    else:
        raise RuntimeError("crash drive (10e): the restarted notary signed a double spend")
    for node in net.nodes:
        node.services.db.close()
    return out


def phase_clusters(device, card: str, fx) -> dict:
    """Phase 10 (module docstring); returns the launches of its run."""
    import os
    import tempfile

    os.environ["CORDA_TPU_NOTARY_PROFILE"] = "1"
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import notary_hub

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "corda_tpu_torch")
    os.makedirs(scratch, exist_ok=True)
    t_phase = time.perf_counter()
    _zero_counters()
    with tempfile.TemporaryDirectory(dir=scratch, prefix="clusters-") as tmp:
        verifier = _recording_verifier((CHUNK,), device)
        hub = notary_hub(fx, verifier)
        n = min(DURABLE_FLUSH, len(fx.spends))
        head = dataclasses.replace(fx, spends=fx.spends[:n], labels=fx.labels[:n],
                                   owners=fx.owners[:n])
        wire = [ser.encode(stx) for stx in head.spends]
        durable = {}
        for shards in (1, 4):
            durable[shards] = durable_flush(head, hub, wire, verifier, shards,
                                            os.path.join(tmp, f"notary-s{shards}.db"), card)

        flows = _recording_verifier(CLUSTER_BATCHES, device)
        for sub in ("raft", "raft-cpu", "crash"):
            os.makedirs(os.path.join(tmp, sub))
        drive = raft_drive(flows, os.path.join(tmp, "raft"))
        ledger = drive["ledger"]
        rows = [len(r) for r, _ in flows.calls]
        print(f"raft drive (10b): {len(ledger['ids'])} flows completed and "
              f"{len(ledger['refused'])} refused in {drive['wall_s']:.3f} s = "
              f"{len(ledger['ids']) / drive['wall_s']:.3f} flows/s; {len(rows)} card verify "
              f"calls = {len(rows) / len(ledger['ids']):.2f} per flow, rows per call "
              f"{min(rows)}-{max(rows)} (mean {sum(rows) / len(rows):.2f}); per flow "
              f"{json.dumps(ledger['calls'])}; leaders {ledger['leaders']}; refused "
              f"{ledger['refused']}; balances {ledger['balances']}; {card}")
        transfer = raft_transfer(drive, RAFT_ENTRIES, card)
        bft = bft_drive(drive["net"], flows.calls, card)
        for node in drive["net"].nodes:
            node.services.db.close()

        t0 = time.perf_counter()
        crash = crash_drive(flows, os.path.join(tmp, "crash"))
        crash_s = time.perf_counter() - t0
        launches = _read_counters()

        t0 = time.perf_counter()
        cpu = raft_drive(CpuBatchVerifier(), os.path.join(tmp, "raft-cpu"))
        for node in cpu["net"].nodes:
            node.services.db.close()
        _same_ledger(ledger, cpu["ledger"], "raft drive (10b)")
        print(f"raft drive (10b) over CpuBatchVerifier in {time.perf_counter() - t0:.3f} s: the "
              f"same {len(ledger['ids'])} transaction ids, cluster signatures, refusals, "
              f"leaders and balances")
        memory = crash_drive(flows, None)
        if memory["page"] != crash["page"]:
            raise RuntimeError("crash drive (10e): the sqlite vault page differs from the "
                               "in-memory network's")
    print(f"crash drive (10e): Alice's vault page equal before and after restart_node and to an "
          f"in-memory network's; the checkpointed payment finished after the restart; the "
          f"restarted notary refused a double spend ({crash['refused']}); {crash_s:.3f} s; "
          f"{card}")
    for kernel in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in the cluster phase")
    print(f"clusters (ph. 10) launches: {json.dumps(launches)}; durable notarisations/s "
          f"{json.dumps({k: round(v['rate'], 1) for k, v in durable.items()})}; raft commits "
          f"{transfer['commit_s']:.3f} s, transfer {transfer['transfer_s']:.3f} s; bft "
          f"{bft['wall_s']:.3f} s; wall {time.perf_counter() - t_phase:.3f} s; {card}")
    return launches


# -- phase 11: real sockets — node boot, the CLI and the pool over TCP --------

NODE_SEED = 17               # every phase-11 node's dev key seed
NODE_BATCH_WAIT = 300_000    # 11a: µs the hub's batching notary holds a flush open
NODE_CONCURRENT = 1          # 11a: concurrent payments per payer (two payers; 4, 2 cut)
NODE_TIMEOUT = 180.0         # s any one node-drive step may take before the phase fails
TCP_POOL_WINDOW = 256        # 11d: a worker's --batch-window (requests per handler drain)
TCP_POOL_KILL_AT = 0.25      # 11d: share of answers after which worker 0 gets SIGKILL
TCP_POOL_DEADLINE = 600_000_000   # 11d: the pool's attempt and request deadlines (µs)
TCP_POOL_REQUESTS = 2048     # 11d: the first phase-6 spends as requests (16,384, 4,096 cut)
TCP_POOL_LEASE = 30_000_000  # 11d: the pool's lease (µs) for the burst; the default 10 s
#                              is shorter than a heartbeat's wait behind the burst's frames


class _NodeRig:
    """In-process port nodes (node/node.py) over real sockets on
    127.0.0.1, each booted from a NodeConfig with TLS from its
    certificates/tls.pem (testing/dev_tls.py), pumped by one thread."""

    def __init__(self, root: str, backend: str):
        import os

        self.root, self.backend = root, backend
        self.nodes: list = []
        self.tls = 0
        self.tls_source = None
        os.makedirs(root, exist_ok=True)

    def boot(self, name: str, hub=None, **kw):
        import os

        from corda_tpu_torch.node.config import NodeConfig, RpcUserConfig
        from corda_tpu_torch.node.node import Node
        from corda_tpu_torch.testing.dev_tls import DEV_TLS_COUNT, provision_tls

        base = os.path.join(self.root, name)
        if not os.path.exists(os.path.join(base, "certificates", "tls.pem")):
            _, self.tls_source = provision_tls(base, name, self.tls % DEV_TLS_COUNT)
            self.tls += 1
        if hub is not None:
            kw.update(network_map_peer=hub.config.name, network_map_host="127.0.0.1",
                      network_map_port=hub.messaging.listen_port,
                      network_map_fingerprint=hub.tls.fingerprint)
        cfg = NodeConfig(name=name, base_dir=base, key_seed=NODE_SEED,
                         verifier_backend=self.backend,
                         rpc_users=(RpcUserConfig("admin", "pw", ("ALL",)),), **kw)
        node = Node(cfg).start()
        self.nodes.append(node)
        return node

    def restart(self, node):
        from corda_tpu_torch.node.node import Node

        self.stop(node)
        fresh = Node(node.config).start()
        self.nodes.append(fresh)
        return fresh

    def pump_until(self, pred, label: str, timeout: float = NODE_TIMEOUT) -> None:
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise RuntimeError(f"{label}: not done within {timeout:.0f} s")
            for n in self.nodes:
                n.pump()

    def discover(self, label: str) -> None:
        n = len(self.nodes)
        self.pump_until(lambda: all(len(x.services.network_map_cache.all_nodes()) == n
                                    for x in self.nodes), f"{label}: discovery")

    def run(self, node, logic, label: str):
        fsm = node.smm.start_flow(logic)
        self.pump_until(lambda: fsm.done, label)
        return fsm.result_or_throw()

    def refused(self, node, logic, label: str, exc_type, kinds=None) -> list:
        fsm = node.smm.start_flow(logic)
        self.pump_until(lambda: fsm.done, label)
        try:
            fsm.result_or_throw()
        except exc_type as e:
            kind = getattr(getattr(e, "error", None), "kind", None)
            if kinds is not None and kind not in kinds:
                raise RuntimeError(f"{label}: refused as {kind!r}, not one of {kinds}") from e
            return [label, type(e).__name__, kind]
        raise RuntimeError(f"{label}: was not refused")

    def stop(self, node) -> None:
        node.stop()
        self.nodes.remove(node)

    def close(self) -> None:
        for n in list(self.nodes):
            self.stop(n)


def _wire_counts(node) -> dict:
    """A node's fabric: frames and payload bytes in its inbound journal
    (the retained dedupe rows), its outbound journal's depth."""
    frames, size = node.db.query("SELECT COUNT(*), COALESCE(SUM(LENGTH(payload)), 0) "
                                 "FROM fabric_in")[0]
    return {"frames_in": frames, "bytes_in": size, **node.messaging.wire_depths()}


def _node_ledger(nodes, hub) -> dict:
    """Balances, every consumed state ref and the hub's notary commits."""
    from corda_tpu_torch.finance import CashState

    return {
        "balances": {n.config.name: _cash_of(n) for n in nodes},
        "consumed": sorted({str(s.ref) for n in nodes
                            for s in n.vault.consumed_states(CashState)}),
        "commits": [list(r) for r in hub.db.query(
            "SELECT ref_tx, ref_index, consumer, requester FROM notary_commits"
            " ORDER BY ref_tx, ref_index")],
    }


def _same_node_ledger(card: dict, cpu: dict, label: str = "trio (11a)") -> None:
    for key in ("ids", "refused", "balances", "consumed", "commits"):
        if card[key] != cpu[key]:
            raise RuntimeError(f"{label}: the card nodes' {key} differ from the "
                               f"CpuBatchVerifier nodes'")


def node_trio_drive(root: str, backend: str, calls=None) -> dict:
    """Phase 11a: Hub (map host, batching notary of one shard over the
    persistent uniqueness provider), Alice (ed25519), Bob (p256) and Carol
    (secp256k1) as port nodes over TCP and TLS. Discovery; an issue;
    payments across the schemes (Carol resolves a backchain of two);
    NODE_CONCURRENT payments each from Alice and Bob started together; a
    flipped signature refused at finality and by the notary; a double
    spend refused "conflict"; Bob stopped and rebooted from his base_dir,
    his vault read back, a payment to him settled. Raises unless every
    outcome and balance is the expected one; returns the ledger and the
    figures."""
    import dataclasses

    from corda_tpu_torch.crypto.tx_signature import InvalidSignature
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.flows.core_flows import FinalityFlow, NotaryFlow
    from corda_tpu_torch.node.notary import NotaryException
    from corda_tpu_torch.node.vault_query import ALL, VaultQueryCriteria

    calls = calls if calls is not None else []
    rig = _NodeRig(root, backend)
    try:
        t_boot = time.perf_counter()
        hub = rig.boot("Hub", notary="batching", notary_batch_wait_micros=NODE_BATCH_WAIT)
        alice = rig.boot("Alice", hub)
        bob = rig.boot("Bob", hub, scheme="secp256r1")
        carol = rig.boot("Carol", hub, scheme="secp256k1")
        rig.discover("trio (11a)")
        boot_s = time.perf_counter() - t_boot
        notary = hub.party
        ledger = {"ids": [], "refused": []}
        calls_at = {}
        t0 = time.perf_counter()
        n0 = len(calls)

        def run(label, node, logic):
            stx = rig.run(node, logic, f"trio (11a) {label}")
            ledger["ids"].append(str(stx.id))
            return stx

        run("issue", alice, CashIssueFlow(1000, "USD", alice.party, notary))
        run("pay Alice -> Bob", alice, CashPaymentFlow(400, "USD", bob.party))
        run("pay Bob -> Carol", bob, CashPaymentFlow(150, "USD", carol.party))
        run("pay Carol -> Alice", carol, CashPaymentFlow(50, "USD", alice.party))
        for payer in (alice, bob):
            for k in range(NODE_CONCURRENT):   # distinct amounts: distinct transactions
                run(f"issue to {payer.config.name}", alice,
                    CashIssueFlow(30 + k, "USD", payer.party, notary))
        batches = hub.services.notary_service.metrics.counter("Notary.BatchesDispatched")
        flushes0 = batches.count
        fsms = [payer.smm.start_flow(CashPaymentFlow(25, "USD", carol.party))
                for payer in (alice, bob) for _ in range(NODE_CONCURRENT)]
        rig.pump_until(lambda: all(f.done for f in fsms), "trio (11a) concurrent payments")
        ledger["ids"] += [str(f.result_or_throw().id) for f in fsms]
        concurrent_flushes = batches.count - flushes0

        coin = min(alice.vault.unconsumed_states(CashState),
                   key=lambda s: (s.state.data.amount.quantity, str(s.ref)))
        q = coin.state.data.amount.quantity
        good = _spend(alice, coin, notary, bob.party)
        sig = good.sigs[0]
        flipped = dataclasses.replace(good, sigs=(dataclasses.replace(
            sig, signature=bytes([sig.signature[0] ^ 1]) + sig.signature[1:]),))
        ledger["refused"].append(rig.refused(alice, FinalityFlow(flipped),
                                             "flipped signature at finality", InvalidSignature))
        ledger["refused"].append(rig.refused(
            alice, NotaryFlow(flipped), "flipped signature at the notary", NotaryException,
            ("invalid-transaction", "invalid-signature")))
        run("spend Alice -> Bob", alice, FinalityFlow(good))
        ledger["refused"].append(rig.refused(
            alice, FinalityFlow(_spend(alice, coin, notary, carol.party)),
            "double spend Alice -> Carol", NotaryException, ("conflict",)))
        flows_s = time.perf_counter() - t0
        flows = len(ledger["ids"]) + len(ledger["refused"])
        n_calls = len(calls) - n0

        def page(node):
            p = node.vault.query_by(VaultQueryCriteria(status=ALL))
            return [sorted(str(s.ref) for s in p.states), p.total_states_available]

        before = page(bob)
        bob = rig.restart(bob)
        if page(bob) != before:
            raise RuntimeError("trio (11a): Bob's vault page changed across the restart")
        rig.discover("trio (11a) after Bob's restart")
        run("pay Carol -> Bob (Bob restarted)", carol, CashPaymentFlow(10, "USD", bob.party))

        nodes = (hub, alice, bob, carol)
        out = _node_ledger(nodes, hub)
        out.update(ledger)
        n = NODE_CONCURRENT
        issued = 30 * n + n * (n - 1) // 2 - 25 * n   # each payer's issues less its payments
        want = {"Hub": 0, "Alice": 650 + issued - q, "Bob": 260 + issued + q,
                "Carol": 90 + 50 * n}
        if out["balances"] != want:
            raise RuntimeError(f"trio (11a): balances {out['balances']}, expected {want}")
        if not out["commits"]:
            raise RuntimeError("trio (11a): the hub's notary committed nothing")
        rows = [len(r) for r, _ in calls[n0:n0 + n_calls]]
        return {"ledger": out, "boot_s": boot_s, "flows": flows, "flows_s": flows_s,
                "calls": n_calls, "rows": rows, "concurrent_flushes": concurrent_flushes,
                "wire": {n.config.name: _wire_counts(n) for n in nodes},
                "tls": rig.tls_source}
    finally:
        rig.close()


def node_cluster_drive(root: str, backend: str, kind: str) -> dict:
    """Phase 11b: a `raft-validating` cluster of 3 or a `bft` cluster of 4
    (f = 1) with a map host and Alice, as port nodes over TCP and TLS: an
    issue, a spend, a double spend refused "conflict"; for Raft the
    leader is stopped, the survivors elect and a payment settles."""
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.flows.core_flows import FinalityFlow
    from corda_tpu_torch.node.notary import NotaryException
    from corda_tpu_torch.node.raft import LEADER

    label = f"{kind} cluster (11b)"
    raft = kind == "raft"
    members = ("N0", "N1", "N2") if raft else ("B0", "B1", "B2", "B3")
    rig = _NodeRig(root, backend)
    try:
        hub = rig.boot("Hub")
        for m in members:
            rig.boot(m, hub, notary="raft-validating" if raft else "bft", cluster_peers=members)
        alice = rig.boot("Alice", hub)
        rig.discover(label)
        if raft:
            rig.pump_until(lambda: sum(1 for n in rig.nodes
                                       if n.raft and n.raft.role == LEADER) == 1,
                           f"{label}: election")
        t0 = time.perf_counter()
        notary = alice.services.network_map_cache.notary_identities()[0]
        ids = [str(rig.run(alice, CashIssueFlow(100, "USD", alice.party, notary),
                           f"{label} issue").id)]
        coin, = alice.vault.unconsumed_states(CashState)
        ids.append(str(rig.run(alice, FinalityFlow(_spend(alice, coin, notary, hub.party)),
                               f"{label} spend").id))
        refused = [rig.refused(alice, FinalityFlow(_spend(alice, coin, notary, alice.party)),
                               f"{label} double spend", NotaryException, ("conflict",))]
        leaders = []
        if raft:
            leader, = [n for n in rig.nodes if n.raft and n.raft.role == LEADER]
            leaders.append(leader.config.name)
            rig.stop(leader)
            rig.pump_until(lambda: sum(1 for n in rig.nodes
                                       if n.raft and n.raft.role == LEADER) == 1,
                           f"{label}: election among the survivors")
            leaders += [n.config.name for n in rig.nodes if n.raft and n.raft.role == LEADER]
            ids.append(str(rig.run(alice, CashIssueFlow(60, "USD", alice.party, notary),
                                   f"{label} issue after the failover").id))
            ids.append(str(rig.run(alice, CashPaymentFlow(30, "USD", hub.party),
                                   f"{label} payment after the failover").id))
        balances = {"Hub": _cash_of(hub), "Alice": _cash_of(alice)}
        want = {"Hub": 130, "Alice": 30} if raft else {"Hub": 100, "Alice": 0}
        if balances != want:
            raise RuntimeError(f"{label}: balances {balances}, expected {want}")
        return {"ids": ids, "refused": refused, "leaders": leaders, "balances": balances,
                "wall_s": time.perf_counter() - t0, "tls": rig.tls_source}
    finally:
        rig.close()


CARD_LOCK_ENV = "CHIP_SMOKE_CARD_LOCK"   # the lanes' lock file (main sets it)


@contextmanager
def card_processes(exclusive: bool):
    """Held while a part starts and stops processes that hold a CUDA
    context. The parts that count the card's contexts (11c, 11d, 12a)
    hold it exclusively, so that no process of another lane ends
    between their counts; 13d's worker holds it shared. A no-op unless
    CARD_LOCK_ENV names the lock file, as it does in main's lanes."""
    path = os.environ.get(CARD_LOCK_ENV)
    if not path:
        yield
        return
    import fcntl

    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _cuda_contexts() -> int:
    """CUDA contexts on the card: one line per process in nvidia-smi's
    compute apps. In a container the pids it prints are not the
    processes' own, so contexts are counted, before and while the
    processes run."""
    return sum(1 for line in _smi_apps().splitlines() if line.strip())


def _smi_apps() -> str:
    return subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout


def _spawn(args: list, log: str):
    """A port process (`python -m ...`) with the repo on its path, its
    stdout and stderr to `log` (.out / .err)."""
    import os

    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
        return subprocess.Popen([sys.executable, *args], stdout=out, stderr=err, env=env,
                                cwd=here)


def _read_port(proc, log: str, timeout: float = 120.0) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(log + ".out") as f:
            for line in f:
                if line.startswith("P2P_PORT="):
                    return int(line.strip().split("=")[1])
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    with open(log + ".err") as f:
        err = f.read()[-2000:]
    raise RuntimeError(f"{log}: no P2P_PORT line (exit {proc.poll()}): {err}")


def _stop_process(proc, label: str, sig, timeout: float = 15.0) -> float:
    """Signal a process and require exit code 0 within `timeout`; returns
    the seconds it took."""
    t0 = time.perf_counter()
    proc.send_signal(sig)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise RuntimeError(f"{label}: did not exit within {timeout:.0f} s of {sig!r}")
    if rc != 0:
        raise RuntimeError(f"{label}: exit code {rc} after {sig!r}")
    return time.perf_counter() - t0


def cli_drive(root: str, backend: str = "tpu", check_contexts: bool = True) -> dict:
    """Phase 11c: two `python -m corda_tpu_torch.node --config <toml>
    --print-port` processes with the default backend (the card): CliHub
    (map host, validating notary) and CliBob. A console endpoint in this
    process starts, over RPCClient, CashIssueFlow on CliHub (1,000 to
    CliBob) and a CashPaymentFlow on CliBob (300 back to CliHub,
    notarised and verified by CliHub) and queries both vaults; each node's pid must hold a CUDA
    context; SIGTERM must end each with exit code 0 within 15 s."""
    import os
    import signal

    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow
    from corda_tpu_torch.node import rpc as rpclib
    from corda_tpu_torch.node.config import NodeConfig, RpcUserConfig, write_config
    from corda_tpu_torch.node.fabric import FabricEndpoint, PeerAddress
    from corda_tpu_torch.node.persistence import NodeDatabase
    from corda_tpu_torch.node.vault_query import VaultQueryCriteria
    from corda_tpu_torch.testing.dev_tls import provision_tls

    os.makedirs(root, exist_ok=True)
    users = (RpcUserConfig("admin", "pw", ("ALL",)),)
    procs, targets, source = {}, {}, None
    ep = db = None
    ctx0 = _cuda_contexts() if check_contexts else 0
    contexts = None
    try:
        for k, name in enumerate(("CliHub", "CliBob")):
            base = os.path.join(root, name)
            fp, source = provision_tls(base, name, k)
            kw = {"notary": "validating"} if name == "CliHub" else dict(
                network_map_peer="CliHub", network_map_host="127.0.0.1",
                network_map_port=targets["CliHub"].port,
                network_map_fingerprint=targets["CliHub"].tls_fingerprint)
            toml = os.path.join(root, f"{name}.toml")
            write_config(NodeConfig(name=name, base_dir=base, key_seed=NODE_SEED,
                                    verifier_backend=backend, rpc_users=users, **kw), toml)
            log = os.path.join(root, name)
            procs[name] = _spawn(["-m", "corda_tpu_torch.node", "--config", toml,
                                  "--print-port", "--log-level", "WARNING"], log)
            targets[name] = PeerAddress("127.0.0.1", _read_port(procs[name], log), fp)
        db = NodeDatabase(os.path.join(root, "console.db"))
        ep = FabricEndpoint("console", schemes.generate_keypair(seed=NODE_SEED), db,
                            resolve=targets.get)
        ep.start()
        hub_rpc = rpclib.RPCClient(ep, "CliHub", "admin", "pw")
        bob_rpc = rpclib.RPCClient(ep, "CliBob", "admin", "pw")

        def call(fut, label):
            deadline = time.monotonic() + NODE_TIMEOUT
            while not fut.done:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"cli (11c): {label} not answered")
                ep.pump(block=True, timeout=0.05)
            return fut.get()

        t0 = time.perf_counter()
        deadline = time.monotonic() + NODE_TIMEOUT
        while len(call(hub_rpc.network_map_snapshot(), "map snapshot")) < 2:
            if time.monotonic() > deadline:
                raise RuntimeError("cli (11c): CliBob never registered with CliHub's map")
            time.sleep(0.1)
        hub_party = call(hub_rpc.node_identity(), "hub identity").legal_identity
        bob_party = call(bob_rpc.node_identity(), "bob identity").legal_identity
        ids = []
        for rpc, logic in ((hub_rpc, CashIssueFlow(1000, "USD", bob_party, hub_party)),
                           (bob_rpc, CashPaymentFlow(300, "USD", hub_party))):
            handle = call(rpc.start_flow(logic), type(logic).__name__)
            ids.append(str(call(handle.result, f"{type(logic).__name__} result").id))
        pages = {}
        for name, rpc in (("CliHub", hub_rpc), ("CliBob", bob_rpc)):
            page = call(rpc.vault_query_by(VaultQueryCriteria()), f"{name} vault")
            pages[name] = sum(s.state.data.amount.quantity for s in page.states)
        if pages != {"CliHub": 300, "CliBob": 700}:
            raise RuntimeError(f"cli (11c): vault balances over RPC {pages}")
        wall = time.perf_counter() - t0
        apps = _smi_apps() if check_contexts else ""
        contexts = _cuda_contexts() if check_contexts else None
        if check_contexts and contexts - ctx0 < len(procs):
            raise RuntimeError(f"cli (11c): {contexts - ctx0} new CUDA contexts for "
                               f"{len(procs)} node processes (nvidia-smi compute apps: "
                               f"{apps.strip()!r})")
        stops = {n: _stop_process(p, f"cli (11c) {n}", signal.SIGTERM)
                 for n, p in procs.items()}
        return {"ids": ids, "balances": pages, "wall_s": wall, "stop_s": stops,
                "apps": apps.strip(), "contexts": (ctx0, contexts), "tls": source}
    finally:
        if ep is not None:
            ep.stop()
            db.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _pool_state(svc, root: str) -> str:
    """What a failed 11d run leaves to read: the pool's counters and the
    end of each worker's stderr."""
    import os

    m = svc.metrics
    tails = {}
    for k in range(POOL_WORKERS):
        path = os.path.join(root, f"w{k}.err")
        if os.path.exists(path):
            with open(path) as f:
                tails[f"w{k}"] = f.read()[-600:]
    return (f"workers {svc.worker_count}, in flight {svc.in_flight}, lost "
            f"{m.meter('Verifier.WorkersLost').count}, redispatched "
            f"{m.meter('Verifier.Redispatched').count}; worker stderr {tails}")


def _silence(heard: dict, worker: str, t0: float) -> float:
    """The longest time since `t0` in which the node processed no
    heartbeat of `worker`, the gap after its last one included."""
    last, longest = heard.get(worker, (t0, 0.0))
    return max(longest, time.perf_counter() - last)


def pool_tcp_drive(root: str, ltxs, stxs, cpu_workers: bool = False,
                   check_contexts: bool = True) -> dict:
    """Phase 11d: a port node with `verifier_type = "out_of_process"`
    (TLS off: a worker dials the node by address, as the reference's
    worker does) and two `python -m corda_tpu_torch.node.verifier`
    processes. A warm-up request each, after which each worker must hold
    a CUDA context (with `check_contexts`: one more context on the card
    per worker); then worker 0 is frozen (SIGSTOP), so that it holds its
    share of the batch unanswered whatever the timing, and every (ltx,
    stx) goes through the pool over the durable journals. Once
    TCP_POOL_KILL_AT of the answers are in, worker 0 gets SIGKILL: its
    nonces re-dispatch to the survivor when its lease expires. A
    worker's heartbeats ride the same journaled frames as its answers,
    so under the burst the node processes them further apart than the
    default 10 s lease and can detach the survivor too (ROADMAP Queue
    3): the burst runs with a lease of TCP_POOL_LEASE. Raises unless
    every future is answered exactly once and only worker 0 was lost;
    returns the answers and the figures, with the survivor's longest
    silence at the node (seconds between two of its heartbeats that
    the node processed)."""
    import dataclasses
    import os
    import signal

    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node
    from corda_tpu_torch.node.verifier import TOPIC_READY

    os.makedirs(root, exist_ok=True)
    label = "pool over TCP (11d)"
    node = Node(NodeConfig(name="PoolNode", base_dir=os.path.join(root, "PoolNode"),
                           key_seed=NODE_SEED, use_tls=False,
                           verifier_type="out_of_process")).start()
    svc = node.verifier_service
    # a burst of thousands of requests queues past the pool's default
    # 5 s attempt and 30 s request deadlines, and can hold the survivor's
    # heartbeats back past the default 10 s lease
    svc.policy = dataclasses.replace(svc.policy, attempt_timeout_micros=TCP_POOL_DEADLINE,
                                     request_timeout_micros=TCP_POOL_DEADLINE,
                                     lease_micros=TCP_POOL_LEASE)
    workers = []
    base = _cuda_contexts() if check_contexts else 0
    contexts = None
    try:
        for k in range(POOL_WORKERS):
            log = os.path.join(root, f"w{k}")
            args = ["-m", "corda_tpu_torch.node.verifier", "--name", f"w{k}",
                    "--node", "PoolNode", "--node-port", str(node.messaging.listen_port),
                    "--db", os.path.join(root, f"w{k}.db"), "--seed", str(k + 2),
                    "--batch-window", str(TCP_POOL_WINDOW)]
            workers.append(_spawn(args + (["--cpu"] if cpu_workers else []), log))
        deadline = time.monotonic() + NODE_TIMEOUT
        while svc.worker_count < POOL_WORKERS:
            if time.monotonic() > deadline or any(w.poll() is not None for w in workers):
                raise RuntimeError(f"{label}: {svc.worker_count} workers attached")
            node.pump(timeout=0.05)
        warm = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs[:POOL_WORKERS], stxs)]
        while not all(f.done for f in warm):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{label}: the warm-up requests were not answered")
            node.pump(timeout=0.05)
        if check_contexts:
            contexts = _cuda_contexts()
            if contexts - base < POOL_WORKERS:
                raise RuntimeError(f"{label}: {contexts - base} new CUDA contexts for "
                                   f"{POOL_WORKERS} workers ({_smi_apps().strip()!r})")
        workers[0].send_signal(signal.SIGSTOP)
        heard: dict = {}       # worker -> (last heartbeat processed, longest silence)

        def on_ready(msg):
            now = time.perf_counter()
            last, longest = heard.get(msg.sender, (now, 0.0))
            heard[msg.sender] = (now, max(longest, now - last))

        node.messaging.add_handler(TOPIC_READY, on_ready)
        m = svc.metrics
        success = m.meter("TransactionVerifierService.Verification.Success")
        failure = m.meter("TransactionVerifierService.Verification.Failure")
        accepted0 = success.count + failure.count    # the warm-up answers
        n = len(ltxs)
        with _GcClock() as gc_clock:
            t0 = time.perf_counter()
            futs = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs, stxs)]
            send_s = time.perf_counter() - t0
            deliver_s = killed_at = None
            next_probe = 0.0
            deadline = time.monotonic() + NODE_TIMEOUT
            while True:
                node.pump(timeout=0.005)
                answered = sum(1 for f in futs if f.done)
                now = time.perf_counter() - t0
                if deliver_s is None and now >= next_probe:
                    next_probe = now + 0.05
                    live = [f"w{k}" for k in range(POOL_WORKERS)
                            if killed_at is None or k != 0]
                    backlog = node.messaging.wire_depths()["backlog"]
                    if not any(backlog.get(w, 0) for w in live):
                        deliver_s = now
                if killed_at is None and answered >= TCP_POOL_KILL_AT * n:
                    workers[0].send_signal(signal.SIGKILL)
                    workers[0].wait()
                    killed_at = (now, answered)
                if answered == n:
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{label}: {n - answered} of {n} unanswered; "
                                       f"{_pool_state(svc, root)}")
            wall = time.perf_counter() - t0
        answers = [_verdict(f) for f in futs]
        accepted = success.count + failure.count - accepted0
        redispatched = m.meter("Verifier.Redispatched").count
        lost = m.meter("Verifier.WorkersLost").count
        if accepted != n or svc.in_flight:
            raise RuntimeError(f"{label}: {accepted} answers accepted for {n} requests; "
                               f"{_pool_state(svc, root)}")
        if killed_at is None or lost != 1 or redispatched == 0:
            raise RuntimeError(f"{label}: killed at {killed_at}, workers lost {lost}, "
                               f"redispatched {redispatched}; {_pool_state(svc, root)}")
        stop_s = _stop_process(workers[1], f"{label} w1", signal.SIGINT)
        with open(os.path.join(root, "w1.err")) as f:
            summary = [line.strip() for line in f if line.startswith("verifier worker")]
        return {"answers": answers, "wall_s": wall, "send_s": send_s,
                "deliver_s": deliver_s, "killed_at": killed_at, "redispatched": redispatched,
                "lost": lost, "survivor": summary, "stop_s": stop_s, "gc": str(gc_clock),
                "contexts": (base, contexts), "silence_s": _silence(heard, "w1", t0),
                "lease_s": svc.policy.lease_micros / 1e6}
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        node.stop()


# 11a over verifier_backend = "cpu" in a child process; argv[1] is its root
TRIO_CPU_DRIVE = (
    "import json, os, sys; sys.path.insert(0, os.getcwd()); import chip_smoke as cs; "
    "r = cs.node_trio_drive(sys.argv[1], 'cpu'); "
    "print('CPU_DRIVE ' + json.dumps({'ledger': r['ledger']}, default=bytes.hex))")


def _cpu_drive(code: str, root: str):
    """A child process running `code` (a CPU-verifier rerun of a drive)
    in `root`, beside the card's drive in this process: the CPU's nodes
    launch nothing. Read it with `_cpu_drive_result`."""
    return subprocess.Popen([sys.executable, "-c", code, root],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _cpu_drive_result(proc, timeout: float, label: str) -> dict:
    """The JSON the child printed on its CPU_DRIVE line; raises unless it
    exited 0 with exactly one."""
    out, err = proc.communicate(timeout=timeout)
    lines = [line for line in out.splitlines() if line.startswith("CPU_DRIVE ")]
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"{label}: the CPU drive's process exited {proc.returncode}: "
                           f"{err[-800:]}")
    return json.loads(lines[0][len("CPU_DRIVE "):])


def phase_nodes(device, card: str, fx) -> dict:
    """Phase 11 (module docstring); returns the in-process launches of
    11a and 11b."""
    import os
    import tempfile

    from corda_tpu_torch.crypto import batch_verifier as bv
    from corda_tpu_torch.testing.notary_fixture import notary_hub

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "corda_tpu_torch")
    os.makedirs(scratch, exist_ok=True)
    t_phase = time.perf_counter()
    verifier = _recording_verifier(CLUSTER_BATCHES, device)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="nodes-") as tmp:
        # the in-process nodes' backend "tpu" is default_verifier(): this
        # recording CudaBatchVerifier on the card
        bv.set_default_verifier(verifier)
        cpu_proc = _cpu_drive(TRIO_CPU_DRIVE, os.path.join(tmp, "trio-cpu"))
        _zero_counters()
        trio = node_trio_drive(os.path.join(tmp, "trio"), "tpu", verifier.calls)
        clusters = {kind: node_cluster_drive(os.path.join(tmp, kind), "tpu", kind)
                    for kind in ("raft", "bft")}
        launches = _read_counters()
        bv.set_default_verifier(None)
        rows = trio["rows"]
        print(f"trio (11a): TLS from {trio['tls']}; booted and discovered in "
              f"{trio['boot_s']:.3f} s; {trio['flows']} flows in {trio['flows_s']:.3f} s = "
              f"{trio['flows'] / trio['flows_s']:.3f} flows/s; {trio['calls']} card verify calls "
              f"= {trio['calls'] / trio['flows']:.2f} per flow, rows per call "
              f"{min(rows)}-{max(rows)} (mean {sum(rows) / len(rows):.2f}); the "
              f"{2 * NODE_CONCURRENT} concurrent payments answered by "
              f"{trio['concurrent_flushes']} notary flush(es); refused "
              f"{trio['ledger']['refused']}; balances {trio['ledger']['balances']}; {card}")
        print(f"trio (11a) fabric: {json.dumps(trio['wire'])}")
        cpu = _cpu_drive_result(cpu_proc, NODE_TIMEOUT, "trio (11a)")
        # the card's ledger as JSON carries it (tuples as lists, bytes as hex)
        _same_node_ledger(json.loads(json.dumps(trio["ledger"], default=bytes.hex)),
                          cpu["ledger"])
        print(f"trio (11a) over verifier_backend = \"cpu\" (its own process): the same "
              f"{len(cpu['ledger']['ids'])} "
              f"transaction ids, refusals, balances, {len(cpu['ledger']['consumed'])} consumed "
              f"refs and {len(cpu['ledger']['commits'])} notary commits")
        for kind, c in clusters.items():
            print(f"{kind} cluster (11b): ids {len(c['ids'])}, refused {c['refused']}, leaders "
                  f"{c['leaders']}, balances {c['balances']}, {c['wall_s']:.3f} s; {card}")
        for kernel in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"):
            if launches[kernel] == 0:
                raise RuntimeError(f"{kernel} was not launched by the phase-11 nodes")

        with card_processes(exclusive=True):
            cli = cli_drive(os.path.join(tmp, "cli"))
        print(f"cli (11c): TLS from {cli['tls']}; issue and payment over RPCClient in "
              f"{cli['wall_s']:.3f} s, ids {cli['ids']}, vaults over RPC {cli['balances']}; "
              f"CUDA contexts on the card {cli['contexts'][0]} before the node processes, "
              f"{cli['contexts'][1]} while they ran (nvidia-smi: {cli['apps']!r}); "
              f"SIGTERM exits 0 in {json.dumps({k: round(v, 3) for k, v in cli['stop_s'].items()})} s; "
              f"{card}")

        hub = notary_hub(fx, bv.CpuBatchVerifier())
        picks = fx.spends[:TCP_POOL_REQUESTS]
        ltxs = [stx.to_ledger_transaction(hub) for stx in picks]
        with card_processes(exclusive=True):
            pool = pool_tcp_drive(os.path.join(tmp, "pool"), ltxs, picks)
    _check_pool_answers(pool["answers"], fx.labels, "pool over TCP (11d)")
    n = len(ltxs)
    print(f"pool over TCP (11d): {n} requests in {pool['wall_s']:.3f} s = "
          f"{n / pool['wall_s']:.1f} verified transactions/s, every answer its label, each "
          f"answered once; journaled in {pool['send_s']:.3f} s, frames delivered through the "
          f"journals in {pool['deliver_s']} s, answered in {pool['wall_s']:.3f} s ({pool['gc']}); "
          f"worker 0 frozen before the batch and killed after {pool['killed_at'][1]} answers "
          f"at {pool['killed_at'][0]:.3f} "
          f"s, workers lost {pool['lost']}, redispatched {pool['redispatched']}; the "
          f"survivor's longest silence at the node {pool['silence_s']:.3f} s of its "
          f"{pool['lease_s']:g} s lease; survivor "
          f"{pool['survivor']}, SIGINT exit 0 in {pool['stop_s']:.3f} s; CUDA contexts "
          f"{pool['contexts'][0]} before the workers, {pool['contexts'][1]} after their warm-up "
          f"requests; {card}")
    print(f"nodes (ph. 11) launches: {json.dumps(launches)}; wall "
          f"{time.perf_counter() - t_phase:.3f} s; {card}")
    return launches


# -- phase 12: the Driver, the load test, the fuzzer's corpus and the demos ---

LOAD_SEED = 31               # 12a: CrossCashLoadTest's seed (the reference soak's)
LOAD_COUNT = 12              # 12a: load-test commands (the soak's 24, then 16, cut for time)
LOAD_BATCH_WAIT = 50_000     # 12a: µs the hub's batching notary holds a flush open (the soak's)
LOAD_EMPTY = 50              # 12a: EmptyFlowLoadTest's round trips on Alice
DEMO_SEED = 42               # 12b, 12d: the demos' default seed
DEMO_TXS = (("batching", 2), ("single", 1))    # 12b: notary_demo flavours and their n_txs (16, 8; 4, 3, 2 cut)
FUZZ_CORPUS = (13, 30)       # 12c: the reference's slow bit-exact test's corpus (seed, n_txs)
FUZZ_SCALE = (17, 500)       # 12c: the same mutation over a 500-transaction ledger (2,000, 1,000 cut)
FUZZ_BATCHES = (128, 1024, 4096)   # 12c: phase 5's buckets
FUZZ_SAMPLE = 256            # 12c: rows of the scaled corpus held against CpuBatchVerifier


def load_drive(root: str, backend: str = "tpu", check_contexts: bool = True) -> dict:
    """Phase 12a: the port's Driver (testing/driver.py) in `root` boots Hub
    (map host, batching notary, LOAD_BATCH_WAIT), Alice (ed25519), Bob
    (p256) and Carol (secp256k1) as `python -m corda_tpu_torch.node`
    processes, on the Driver's default backend (the card) unless `backend`
    names another. CrossCashLoadTest(seed=LOAD_SEED) runs LOAD_COUNT
    commands in a tight loop, a traffic node killed (-9) and restarted at
    0.35 and the notary at 0.65 (the reference soak's disruptions; each
    restart waits until the new process sees the network); then
    EmptyFlowLoadTest on Alice. Raises unless no command failed, the model
    reconciles, every traffic node's vault total over RPC equals the model
    and (with `check_contexts`) the card held at least one new CUDA
    context per node while the commands ran."""
    from corda_tpu_torch.node.vault_query import VaultQueryCriteria
    from corda_tpu_torch.testing.driver import driver
    from corda_tpu_torch.testing.loadtest import (
        CrossCashLoadTest, Disruption, EmptyFlowLoadTest, kill_and_restart)

    label = "load test (12a)"
    kw = {} if backend == "tpu" else {"verifier_backend": backend}
    base = _cuda_contexts() if check_contexts else 0
    contexts = []
    with driver(root) as d:
        boot = {}

        def start(name, **extra):
            t0 = time.perf_counter()
            d.start_node(name, **kw, **extra)
            boot[name] = time.perf_counter() - t0

        start("Hub", notary="batching", timeout=600.0, notary_batch_wait_micros=LOAD_BATCH_WAIT)
        # the map host first; the traffic nodes boot together (each process
        # spends most of its boot importing torch)
        with ThreadPoolExecutor(3) as pool:
            for f in [pool.submit(start, name, **extra) for name, extra in (
                    ("Alice", {}), ("Bob", {"scheme": "secp256r1"}),
                    ("Carol", {"scheme": "secp256k1"}))]:
                f.result()
        d.wait_for_network(4)
        hub = d.nodes["Hub"]
        lt = CrossCashLoadTest(d, [d.nodes[n] for n in ("Alice", "Bob", "Carol")],
                               d.notary_identity(), seed=LOAD_SEED)
        latencies, restarts = [], []
        apply = lt._apply

        def timed_apply(kind, *args):
            t0 = time.perf_counter()
            try:
                apply(kind, *args)
            finally:
                latencies.append((kind, time.perf_counter() - t0))
                if check_contexts:
                    contexts.append(_cuda_contexts())

        def timed_restart(drv, handle):
            # kill -9 and boot, then wait until the replacement's map shows
            # every node, as the Driver waits after a first boot: a node
            # that pays before its map knows the notary validates sends a
            # tear-off, which the notary refuses (both packages)
            t0 = time.perf_counter()
            replacement = kill_and_restart(drv, handle)
            drv.wait_until(lambda: len(drv.wait(drv.rpc(replacement).network_map_snapshot(),
                                                NODE_TIMEOUT)) >= len(drv.nodes), NODE_TIMEOUT)
            restarts.append((handle.name, time.perf_counter() - t0))
            return replacement

        lt._apply = timed_apply
        result = lt.run(count=LOAD_COUNT, timeout_per_flow=NODE_TIMEOUT, disruptions=(
            Disruption("kill+restart traffic node", 0.35, timed_restart),
            Disruption("kill+restart notary", 0.65, timed_restart, target=hub)))
        if result.failed or not result.reconciled:
            raise RuntimeError(f"{label}: {result.failed} of {result.submitted} commands failed, "
                               f"reconciled {result.reconciled}: expected {result.expected}, "
                               f"actual {result.actual}; notary stderr "
                               f"{d.nodes['Hub'].stderr_tail(600)!r}")
        totals = {}
        for node in lt.nodes:
            page = d.wait(d.rpc(node).vault_query_by(VaultQueryCriteria()), NODE_TIMEOUT)
            totals[node.name] = sum(s.state.data.amount.quantity for s in page.states)
        if totals != result.expected:
            raise RuntimeError(f"{label}: vault totals over RPC {totals}, model {result.expected}")
        if check_contexts and max(contexts) - base < len(d.nodes):
            raise RuntimeError(f"{label}: at most {max(contexts) - base} new CUDA contexts for "
                               f"{len(d.nodes)} node processes ({_smi_apps().strip()!r})")
        if len(restarts) != 2:
            raise RuntimeError(f"{label}: {len(restarts)} restarts, expected 2")
        empty = EmptyFlowLoadTest(d, d.nodes["Alice"]).run(count=LOAD_EMPTY)
    def p50(kinds):
        lat = sorted(s for k, s in latencies if k in kinds)
        return lat[len(lat) // 2] if lat else None

    return {"result": result, "totals": totals, "boot_s": boot, "restarts": restarts,
            "p50_s": {"all": p50(("issue", "pay")), "issue": p50(("issue",)),
                      "pay": p50(("pay",))},
            "max_s": max(s for _, s in latencies), "empty": empty,
            "contexts": (base, max(contexts) if contexts else None)}


class recorded_networks:
    """Records every MockNetwork a demo builds (the demos return no
    network): patches `mock_network.MockNetwork`, which the demos import
    when they run, with a subclass that keeps each instance in `.nets`.
    Takes the module, so a test can record either package's networks."""

    def __init__(self, mock_network):
        self.module, self.nets = mock_network, []

    def __enter__(self):
        nets, self.base = self.nets, self.module.MockNetwork

        class Recording(self.base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                nets.append(self)

        self.module.MockNetwork = Recording
        return self

    def __exit__(self, *exc) -> None:
        self.module.MockNetwork = self.base

    def ids(self) -> list:
        """Every transaction id any node of the networks recorded, sorted."""
        return sorted({str(stx.id) for net in self.nets for node in net.nodes
                       for stx in node.services.validated_transactions.all()})


def notary_demo_drive(verifier=None) -> dict:
    """Phase 12b: samples/notary_demo.run for each of DEMO_TXS over
    `verifier` (None: the demo's default, CudaBatchVerifier() on the card),
    then again over CpuBatchVerifier. Raises unless every transaction
    carries one notary signature and both runs leave the same transaction
    ids and signer keys."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.samples import notary_demo
    from corda_tpu_torch.testing import mock_network

    out = {}
    for flavour, n in DEMO_TXS:
        label = f"notary demo {flavour} (12b)"
        runs = []
        for v in (verifier, CpuBatchVerifier()):
            with recorded_networks(mock_network) as rec:
                signers, elapsed = notary_demo.run(flavour, n_txs=n, seed=DEMO_SEED,
                                                   batch_verifier=v)
            runs.append((signers, rec.ids(), elapsed))
        (signers, ids, elapsed), (cpu_signers, cpu_ids, _) = runs
        if len(signers) != n or any(len(s) != 1 for s in signers):
            raise RuntimeError(f"{label}: notary signatures per transaction "
                               f"{[len(s) for s in signers]}, expected {n} of 1")
        if ids != cpu_ids or signers != cpu_signers:
            raise RuntimeError(f"{label}: the ids or signer keys differ from the "
                               f"CpuBatchVerifier run's")
        out[flavour] = {"txs": n, "elapsed_s": elapsed, "ids": len(ids)}
    return out


def mutated_corpus(seed: int, n_txs: int) -> tuple:
    """The reference's fuzz corpus (tests/test_generators.py
    `_mutated_corpus`) with its labels: every signature of
    GeneratedLedger(seed).grow(n_txs), a quarter with the last byte's low
    bit flipped, 15% with a byte added to the payload, 10% truncated to
    half (the draws of random.Random(seed + 1)). Returns (requests,
    labels); a label is True for an intact row, which must verify."""
    from corda_tpu_torch.crypto.batch_verifier import VerificationRequest
    from corda_tpu_torch.testing.generators import GeneratedLedger

    rng = random.Random(seed + 1)
    reqs, labels = [], []
    for pub, sig, payload in GeneratedLedger(seed=seed).grow(n_txs).all_signatures():
        roll = rng.random()
        intact = False
        if roll < 0.25:
            sig = bytes(sig[:-1]) + bytes([sig[-1] ^ 0x01])
        elif roll < 0.4:
            payload = payload + b"\x00"
        elif roll < 0.5 and len(sig) > 4:
            sig = sig[: len(sig) // 2]
        else:
            intact = True
        reqs.append(VerificationRequest(pub, sig, payload))
        labels.append(intact)
    return reqs, labels


def fuzz_drive(verifier, cpu) -> dict:
    """Phase 12c: the FUZZ_CORPUS corpus and the FUZZ_SCALE one through
    `verifier` (one call each); every verdict must equal its label, and
    CpuBatchVerifier's on the whole small corpus and FUZZ_SAMPLE sampled
    rows of the large one."""
    t0 = time.perf_counter()
    small, small_labels = mutated_corpus(*FUZZ_CORPUS)
    big, big_labels = mutated_corpus(*FUZZ_SCALE)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_small = verifier.verify_batch(small)
    got_big = verifier.verify_batch(big)
    verify_s = time.perf_counter() - t0
    pick = sorted(random.Random(FUZZ_SCALE[0]).sample(range(len(big)), FUZZ_SAMPLE))
    cpu_small = cpu.verify_batch(small)
    cpu_big = cpu.verify_batch([big[i] for i in pick])
    for name, got, want in (
            ("30-tx corpus against its labels", got_small, small_labels),
            ("scaled corpus against its labels", got_big, big_labels),
            ("30-tx corpus against CpuBatchVerifier", got_small, cpu_small),
            ("sampled rows against CpuBatchVerifier", [got_big[i] for i in pick], cpu_big)):
        wrong = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if len(got) != len(want) or wrong:
            raise RuntimeError(f"fuzz (12c): {name}: rows {wrong[:8]} differ")
    schemes = {}
    for r in small + big:
        schemes[r.key.scheme_id] = schemes.get(r.key.scheme_id, 0) + 1
    return {"rows": (len(small), len(big)), "intact": (sum(small_labels), sum(big_labels)),
            "schemes": schemes, "gen_s": gen_s, "verify_s": verify_s}


def trader_drive(verifier=None) -> dict:
    """Phase 12d: samples/trader_demo.run over `verifier` (None: the
    demo's default, the card). Raises unless the buyer holds one paper and
    the seller 92,000."""
    from corda_tpu_torch.samples import trader_demo

    t0 = time.perf_counter()
    paper, cash = trader_demo.run(seed=DEMO_SEED, batch_verifier=verifier)
    if len(paper) != 1 or cash != 92_000:
        raise RuntimeError(f"trader demo (12d): buyer paper {len(paper)}, seller cash {cash}")
    return {"paper": len(paper), "cash": cash, "wall_s": time.perf_counter() - t0}


def phase_drives(device, card: str) -> dict:
    """Phase 12 (module docstring); returns the in-process launches of
    12b-12d."""
    import os
    import tempfile

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "corda_tpu_torch")
    os.makedirs(scratch, exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch, prefix="drives-") as tmp:
        with card_processes(exclusive=True):
            load = load_drive(os.path.join(tmp, "load"))
    r = load["result"]
    print(f"load test (12a): nodes booted in "
          f"{json.dumps({k: round(v, 3) for k, v in load['boot_s'].items()})} s; {r.submitted} "
          f"commands, {r.failed} failed, in {r.elapsed_s:.3f} s = {r.throughput:.3f} "
          f"commands/s, per command p50 {load['p50_s']['all']:.3f} s (issues "
          f"{load['p50_s']['issue']:.3f} s, payments {load['p50_s']['pay']:.3f} s), max "
          f"{load['max_s']:.3f} s; "
          f"restarts (kill -9 and boot) {[(n, round(s, 3)) for n, s in load['restarts']]}; "
          f"reconciled, vault totals over RPC {load['totals']}; empty flows "
          f"{load['empty']['count']} at {load['empty']['flows_per_s']:.2f} flows/s, "
          f"{load['empty']['avg_latency_ms']:.2f} ms each; CUDA contexts "
          f"{load['contexts'][0]} before the nodes, at most {load['contexts'][1]} while the "
          f"commands ran; {card}")
    _zero_counters()
    demos = notary_demo_drive()
    for flavour, d in demos.items():
        print(f"notary demo {flavour} (12b): {d['txs']} payments notarised in "
              f"{d['elapsed_s']:.3f} s = {d['txs'] / d['elapsed_s']:.3f} tx/s, one notary "
              f"signature each; {d['ids']} transaction ids and the signer keys equal to "
              f"CpuBatchVerifier's; {card}")
    fuzz = fuzz_drive(CudaBatchVerifier(device=device, batch_sizes=FUZZ_BATCHES),
                      CpuBatchVerifier())
    print(f"fuzz (12c): {fuzz['rows'][0]} + {fuzz['rows'][1]} rows (intact "
          f"{fuzz['intact'][0]} + {fuzz['intact'][1]}; by scheme id {json.dumps(fuzz['schemes'])}), "
          f"generated in {fuzz['gen_s']:.3f} s, verified on the card in {fuzz['verify_s']:.3f} s: "
          f"every verdict its label; the 30-tx corpus and {FUZZ_SAMPLE} sampled rows equal to "
          f"CpuBatchVerifier; {card}")
    trader = trader_drive()
    print(f"trader demo (12d): buyer {trader['paper']} paper, seller {trader['cash']} in "
          f"{trader['wall_s']:.3f} s; {card}")
    launches = _read_counters()
    for kernel in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in 12b-12d")
    print(f"drives (ph. 12) launches in 12b-12d: {json.dumps(launches)}; wall "
          f"{time.perf_counter() - t_phase:.3f} s; {card}")
    return launches


# -- phase 13: the perf, device and wire planes on the card -------------------

TELEMETRY_SPENDS = 4096      # 13a-13c: the first phase-6 spends, one chunk per scheme
TELEMETRY_SAMPLE = 16        # 13a: the first pass's card verdicts held against the CPU
TELEMETRY_PAIRS = 2          # 13c: interleaved on/off pairs of the flush (3 cut)
TELEMETRY_WORKER = 256       # 13d: requests drained by the profiled worker process
TELEMETRY_PROFILE_HZ = 19    # 13d: the worker's --profile-hz
TOPIC_SUBMIT = "telemetry.submit"


@contextmanager
def _private_ledgers():
    """Fresh process kernel and device ledgers (what every
    CudaBatchVerifier records into) for the block, the old ones put back
    after it; yields the device ledger."""
    from corda_tpu_torch.utils import device_telemetry as dlib
    from corda_tpu_torch.utils import perf as plib

    saved = (plib.get_kernel_accounting(), dlib.get_device_accounting())
    acct = dlib.DeviceAccounting()
    plib.set_kernel_accounting(plib.KernelAccounting())
    dlib.set_device_accounting(acct)
    try:
        yield acct
    finally:
        plib.set_kernel_accounting(saved[0])
        dlib.set_device_accounting(saved[1])


class _Planes:
    """The three planes of one phase-13 run over a notary: the perf plane
    attached to the notary, the device plane over the notary's queues
    and the card (`sampler`), the wire plane on the in-memory fabric the
    spends arrive by (the notary's endpoint, and the client's sends), a
    HealthMonitor watching all three. The planes adopt the process
    ledgers of the moment."""

    def __init__(self, svc, fabric, client, sampler):
        from corda_tpu_torch.utils import device_telemetry as dlib
        from corda_tpu_torch.utils import perf as plib
        from corda_tpu_torch.utils import wire_telemetry as wlib
        from corda_tpu_torch.utils.health import HealthMonitor

        self.perf = plib.PerfPlane(metrics=svc.metrics, policy=plib.PerfPolicy(
            sample_gap_micros=0, profile_hz=TELEMETRY_PROFILE_HZ))
        self.device = dlib.DevicePlane(metrics=svc.metrics, perf=self.perf, sampler=sampler,
                                       policy=dlib.DevicePolicy(sample_gap_micros=0))
        self.wire = wlib.WirePlane(metrics=svc.metrics,
                                   policy=wlib.WirePolicy(sample_gap_micros=0))
        self.monitor = HealthMonitor(metrics=svc.metrics)
        self.monitor.watch_perf(self.perf)
        self.monitor.watch_device(self.device)
        self.monitor.watch_wire(self.wire)
        self.device.set_wire_feed(self.wire.wire_host_seconds)
        self._svc, self._fabric, self._client = svc, fabric, client
        svc.attach_device(self.device)
        self.on(True)

    def on(self, flag: bool) -> None:
        """Attach (True) or detach (False) the perf and wire planes."""
        self._svc.attach_perf(self.perf if flag else None)
        if flag:
            self.wire.attach_fabric(self._fabric)
            self._client.telemetry = self.wire.fabric
        else:
            self._fabric.telemetry = self._client.telemetry = None

    def tick(self) -> None:
        self.perf.tick()
        self.device.tick()
        self.wire.tick()
        self.monitor.tick()

    def close(self) -> None:
        self.on(False)


def telemetry_flush(svc, planes, wire: list, fx, verifier, ticked: bool, label: str,
                    sample_rows: int = 0) -> tuple:
    """One 13a/13c pass: every spend's wire bytes over the in-memory
    fabric to the notary's endpoint, decoded there, `process`ed and
    flushed, the answers held to their labels (phase 6's checks, with
    `sample_rows` verdicts against the CPU: phase 6 checked more); with
    `ticked` the planes tick after the flush, inside the wall, and
    garbage collection is off inside it. Returns
    (wall seconds, signature rows dispatched)."""
    from corda_tpu_torch.node.notary import (
        InMemoryUniquenessProvider, finish_process, run_process)

    svc.uniqueness = InMemoryUniquenessProvider()
    verifier.calls = []
    client, received = planes["client"], planes["received"]
    received.clear()
    gc.disable()      # no collection inside either arm of 13c's A/B
    try:
        t0 = time.perf_counter()
        for blob in wire:
            client.send(TOPIC_SUBMIT, blob, "TelemetryNotary")
        planes["net"].run()
        started = run_process([svc.process(stx, fx.requester) for stx in received])
        svc.flush()
        answers = finish_process(started)
        if ticked:
            planes["planes"].tick()
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    disp = _check_notary(fx, svc, answers, verifier.calls, label, sample_rows)
    return wall, disp["rows"]


def _kernel_intervals(events) -> tuple:
    """(window µs, [(start, end, name)] µs of the device activities) of a
    torch.profiler capture's raw events (`prof.profiler.kineto_results
    .events()`, read without building the Python event tree, which takes
    minutes for a chunk's ~200,000 events). The window spans every event;
    user annotations (record_function ranges, also mirrored on the
    device's timeline) are not device work."""
    from torch.autograd import DeviceType

    lo = hi = None
    kernels = []
    for evt in events:
        start, end = evt.start_ns() / 1e3, evt.end_ns() / 1e3
        lo = start if lo is None else min(lo, start)
        hi = end if hi is None else max(hi, end)
        name = evt.name()
        if (evt.device_type() == DeviceType.CUDA and not evt.is_user_annotation()
                and not name.startswith("corda_tpu.")):
            kernels.append((start, end, name))
    return (hi - lo if lo is not None else 0.0), kernels


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e, _ in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_window(verifier, reqs, planes) -> dict:
    """13b: one torch.profiler window (CPU and CUDA activities) over one
    verify_batch of `reqs` (one chunk), with a device plane and ledgers
    of its own, anchored just before and ticked just after, so its busy
    fraction covers the same window. Raises if the capture holds no device time
    or the ladder kernel is not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.utils import device_telemetry as dlib

    # the window's launch, slowed by the profiler, goes to ledgers of its
    # own, not to the flushes' (13a's readings and capacity model)
    with _private_ledgers() as acct:
        # an empty row for the card, so that the window's first tick
        # anchors it (a plane windows only the rows it has seen twice)
        acct.record_transfer(verifier.device.index or 0, 0, 0.0)
        window_plane = dlib.DevicePlane(sampler=planes.device.sampler, accounting=acct,
                                        policy=dlib.DevicePolicy(sample_gap_micros=0,
                                                                 live_buffer_census=False))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window_plane.tick()
            verdicts = verifier.verify_batch(reqs)
            torch.cuda.synchronize()
            window_plane.tick()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
    window_us, kernels = _kernel_intervals(prof.profiler.kineto_results.events())
    t3 = time.perf_counter()
    if not kernels:
        raise RuntimeError("profiler window (13b): no device time in the capture")
    kernel_us = sum(e - s for s, e, _ in kernels)
    ladder_us = sum(e - s for s, e, name in kernels if "ladder" in name)
    ends_us = sum(e - s for s, e, name in kernels if "prologue" in name or "epilogue" in name)
    if ladder_us <= 0:
        raise RuntimeError("profiler window (13b): no ladder kernel in the capture")
    if window_plane.busy_fraction_max() <= 0:
        raise RuntimeError("profiler window (13b): the device plane read no busy time")
    return {"rows": len(reqs), "verdicts": verdicts, "window_ms": window_us / 1e3,
            "capture_s": t1 - t0, "stop_s": t2 - t1, "read_s": t3 - t2,
            "kernels": len(kernels), "kernel_ms": kernel_us / 1e3,
            "ladder_ms": ladder_us / 1e3, "ladder_share": ladder_us / kernel_us,
            "ends_ms": ends_us / 1e3,
            "busy_share": _union_us(kernels) / window_us,
            "plane_busy_fraction": window_plane.busy_fraction_max()}


class ProfiledWorker:
    """13d: a node with `verifier_type = "out_of_process"` (TLS off) and
    one `python -m corda_tpu_torch.node.verifier --profile-hz 19
    --profile-out <root>/p0.folded` process, started (`start`) before
    13a so its boot overlaps the flushes; `drain` sends it requests and
    waits for every answer, then SIGINT must end it with exit 0 and a
    non-empty folded-stack file. `close` stops whatever still runs."""

    label = "profiled worker (13d)"

    def __init__(self, root: str, cpu_worker: bool = False):
        self.root, self.cpu_worker = root, cpu_worker
        self.node = self.proc = None

    def start(self) -> "ProfiledWorker":
        import os

        from corda_tpu_torch.node.config import NodeConfig
        from corda_tpu_torch.node.node import Node

        os.makedirs(self.root, exist_ok=True)
        self.node = Node(NodeConfig(
            name="ProfNode", base_dir=os.path.join(self.root, "ProfNode"), key_seed=NODE_SEED,
            use_tls=False, verifier_type="out_of_process",
            verifier_backend="cpu" if self.cpu_worker else "tpu")).start()
        self.folded = os.path.join(self.root, "p0.folded")
        self.log = os.path.join(self.root, "p0")
        args = ["-m", "corda_tpu_torch.node.verifier", "--name", "p0", "--node", "ProfNode",
                "--node-port", str(self.node.messaging.listen_port),
                "--db", os.path.join(self.root, "p0.db"), "--seed", "2",
                "--batch-window", str(TELEMETRY_WORKER),
                "--profile-hz", str(TELEMETRY_PROFILE_HZ), "--profile-out", self.folded]
        self.t_start = time.perf_counter()
        self.proc = _spawn(args + (["--cpu"] if self.cpu_worker else []), self.log)
        return self

    def drain(self, ltxs, stxs) -> dict:
        import os
        import signal

        svc, node, label = self.node.verifier_service, self.node, self.label
        deadline = time.monotonic() + NODE_TIMEOUT
        while svc.worker_count < 1:
            if time.monotonic() > deadline or self.proc.poll() is not None:
                raise RuntimeError(f"{label}: the worker did not attach")
            node.pump(timeout=0.05)
        attach_s = time.perf_counter() - self.t_start
        t1 = time.perf_counter()
        futs = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs, stxs)]
        while not all(f.done for f in futs):
            if time.monotonic() > deadline or self.proc.poll() is not None:
                raise RuntimeError(f"{label}: {sum(not f.done for f in futs)} of "
                                   f"{len(futs)} unanswered")
            node.pump(timeout=0.01)
        wall = time.perf_counter() - t1
        stop_s = _stop_process(self.proc, label, signal.SIGINT)
        with open(self.log + ".err") as f:
            err = f.read()
        if not os.path.exists(self.folded):
            raise RuntimeError(f"{label}: no folded-stack file ({err[-600:]})")
        with open(self.folded) as f:
            stacks = [line for line in f.read().splitlines() if line]
        if not stacks or not all(line.rsplit(" ", 1)[1].isdigit() for line in stacks):
            raise RuntimeError(f"{label}: the folded-stack file is empty or malformed")
        return {"answers": [_verdict(f) for f in futs], "attach_s": attach_s, "wall_s": wall,
                "stop_s": stop_s, "stacks": len(stacks),
                "samples": sum(int(line.rsplit(" ", 1)[1]) for line in stacks),
                "bytes": os.path.getsize(self.folded),
                "summary": [ln for ln in err.splitlines() if ln.startswith("verifier worker")]}

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.node is not None:
            self.node.stop()


def phase_telemetry(device, card: str, fx, sampler=None, cpu_worker: bool = False) -> dict:
    """Phase 13 (module docstring); returns its figures and the in-process
    launches of 13a-13c. `sampler` and `cpu_worker` are the CPU
    rehearsal's (the default sampler reads the card). The order: the
    worker process starts first, so its boot overlaps the flushes; 13a's
    first flush; 13b's window over a warm chunk; then 13c's interleaved
    on/off flushes, whose first is 13a's warm pass; then 13d's drain."""
    import os
    import tempfile
    import types

    import torch

    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.node.messaging import InMemoryMessagingNetwork
    from corda_tpu_torch.node.notary import BatchingNotaryService, InMemoryUniquenessProvider
    from corda_tpu_torch.testing.notary_fixture import notary_hub
    from corda_tpu_torch.utils import device_telemetry as dlib

    n = min(TELEMETRY_SPENDS, len(fx.spends))
    sub = types.SimpleNamespace(spends=fx.spends[:n], labels=fx.labels[:n],
                                requester=fx.requester)
    t_phase = time.perf_counter()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "corda_tpu_torch")
    os.makedirs(scratch, exist_ok=True)
    cpu_hub = notary_hub(fx, CpuBatchVerifier())
    picks = sub.spends[:TELEMETRY_WORKER]
    ltxs = [stx.to_ledger_transaction(cpu_hub) for stx in picks]
    verifier = _recording_verifier((CHUNK,), device)
    hub = notary_hub(fx, verifier)
    svc = BatchingNotaryService(hub, InMemoryUniquenessProvider(), max_batch=n, shards=1,
                                shard_workers=False, shard_queue_depth=n,
                                degraded_fallback=False)
    net = InMemoryMessagingNetwork()
    client, ep = net.endpoint("TelemetryClient"), net.endpoint("TelemetryNotary")
    received: list = []
    ep.add_handler(TOPIC_SUBMIT, lambda m: received.append(ser.decode(m.payload)))
    wire = [ser.encode(stx) for stx in sub.spends]
    out, marks = {}, {}
    # a tensor held on the card through the phase, which 13a's census must
    # count: a verify call leaves nothing resident on the card (its three
    # kernels take their constants by value)
    resident = torch.ones(1 << 18, dtype=torch.int32, device=device) if sampler is None else None

    def accounting() -> tuple:
        kern = planes.perf.kernels.snapshot()
        rows = {k: {f: (round(v, 6) if isinstance(v, float) else v) for f, v in r.items()
                    if f in ("compiles", "executes", "compile_seconds", "execute_mean_s",
                             "transfer_bytes", "transfer_seconds")}
                for k, r in kern["keys"].items()}
        return kern, rows

    with tempfile.TemporaryDirectory(dir=scratch, prefix="telemetry-") as tmp, \
            _private_ledgers(), card_processes(exclusive=False):
        worker = ProfiledWorker(tmp, cpu_worker=cpu_worker)
        planes = _Planes(svc, ep, client, sampler or dlib.DeviceSampler())
        rig = {"client": client, "net": net, "received": received, "planes": planes}
        try:
            worker.start()
            _zero_counters()
            label = "telemetry (13a) first pass"
            first_s, rows_sent = telemetry_flush(svc, rig, wire, sub, verifier, True, label,
                                                 TELEMETRY_SAMPLE)
            kern, rows = accounting()
            print(f"{label}: {n} spends in {first_s:.3f} s, every answer its label ("
                  f"{TELEMETRY_SAMPLE} card verdicts equal to CpuBatchVerifier's); kernel "
                  f"accounting {json.dumps(rows)}; compiles {kern['compiles']}, retraces "
                  f"{kern['retraces']}; {card}")
            if len(rows) != 2 or kern["retraces"] or any(
                    (r["compiles"], r["executes"]) != (1, 0) for r in rows.values()):
                raise RuntimeError(f"{label}: not one compile for each of the 2 keys (ed25519 "
                                   f"and p256 at batch {CHUNK}): {rows}")
            planes.perf.kernels.mark_warm()
            marks["13a first"] = time.perf_counter() - t_phase

            reqs, pv = verifier.calls[-1]
            ed = [(r, ok) for r, ok in zip(reqs, pv.result())
                  if r.key.scheme_id == schemes.EDDSA_ED25519_SHA512][:CHUNK]
            win = profile_window(verifier, [r for r, _ in ed], planes)
            if win["verdicts"] != [ok for _, ok in ed]:
                raise RuntimeError("profiler window (13b): the verdicts differ from the flush's")
            print(f"telemetry (13b) profiler window over one warm {win['rows']}-row ed25519 "
                  f"chunk (batch {CHUNK}): window {win['window_ms']:.3f} ms, {win['kernels']} "
                  f"device activities, their time {win['kernel_ms']:.3f} ms, the ladder kernel "
                  f"{win['ladder_ms']:.3f} ms = {100 * win['ladder_share']:.2f}% of it, the "
                  f"prologue and epilogue kernels {win['ends_ms']:.3f} ms; the card "
                  f"busy {100 * win['busy_share']:.2f}% of the window; the device plane's busy "
                  f"fraction (launch wall) for the same window {win['plane_busy_fraction']:.4f}; "
                  f"capture {win['capture_s']:.3f} s, profiler stop {win['stop_s']:.3f} s, "
                  f"events read {win['read_s']:.3f} s; {card}")
            out["window"] = win
            marks["13b"] = time.perf_counter() - t_phase

            ab = {"on": [], "off": []}
            for k in range(2 * TELEMETRY_PAIRS):
                mode = ("on", "off")[k % 2]
                planes.on(mode == "on")
                label = ("telemetry (13a) warm pass" if k == 0
                         else f"telemetry (13c) planes {mode}")
                wall, rows = telemetry_flush(svc, rig, wire, sub, verifier, mode == "on", label)
                ab[mode].append(wall)
                if k == 0:
                    rows_sent += rows
                    kern, rows = accounting()
                    print(f"{label} (13c's first planes-on flush): {n} spends in {wall:.3f} s, "
                          f"every answer its label; kernel accounting {json.dumps(rows)}; "
                          f"compiles {kern['compiles']}, retraces {kern['retraces']}; {card}")
                    if kern["retraces"] or any((r["compiles"], r["executes"]) != (1, 1)
                                               for r in rows.values()):
                        raise RuntimeError(f"{label}: after mark_warm the keys recompiled: "
                                           f"{rows}")
                    snap = planes.device.snapshot()
                    cap = planes.device.capacity()
                    alerts = {a: v["state"]
                              for a, v in planes.monitor.snapshot()["alerts"].items()}
                    busy = planes.device.busy_fraction_max()
            planes.on(True)
            overhead = min(ab["on"]) / min(ab["off"]) - 1.0
            launches = _read_counters()
            marks["13c"] = time.perf_counter() - t_phase
            w = worker.drain(ltxs, picks)
            marks["13d"] = time.perf_counter() - t_phase
        finally:
            planes.close()
            worker.close()

    row = next(r for r in snap["devices"] if r["id"] == 0)
    if sampler is None:
        want = ("gpu", torch.cuda.get_device_name(0),
                torch.cuda.get_device_properties(0).total_memory)
        if (row["platform"], row["kind"], row["hbm"]["bytes_limit"]) != want:
            raise RuntimeError(f"telemetry (13a): the device row {row} is not the card")
        held = resident.numel() * resident.element_size()
        if (not row["live_buffers"] or row["live_buffers"]["count"] <= 0
                or row["live_buffers"]["bytes"] < held):
            raise RuntimeError(f"telemetry (13a): the census misses the {held} bytes held on "
                               f"the card: {row}")
    totals = row["dispatch_totals"]
    # the first and warm flushes dispatched one chunk per scheme each
    if not totals or totals["dispatches"] != 4 or totals["requests"] != rows_sent:
        raise RuntimeError(f"telemetry (13a): device ledger {totals}, not 4 dispatches of "
                           f"{rows_sent} requests")
    if totals["transfer_bytes"] <= 0 or totals["transfer_seconds"] <= 0:
        raise RuntimeError(f"telemetry (13a): no timed transfer on the ledger: {totals}")
    if cap["binding_constraint"] is None:
        raise RuntimeError(f"telemetry (13a): the capacity model named nothing: {cap}")
    print(f"telemetry (13a) device row: "
          f"{json.dumps({k: row[k] for k in ('id', 'platform', 'kind', 'hbm', 'live_buffers')})}"
          f"; {card}")
    print(f"telemetry (13a) device ledger cuda:0 (the first and warm flushes): "
          f"{json.dumps(totals)}; busy fraction (max, window) {busy:.4f}, queue wait "
          f"{row['queue_wait_micros']:.1f} us per dispatch; {card}")
    print(f"telemetry (13a) capacity: binding {cap['binding_constraint']} at "
          f"{cap['predicted_ceiling_per_sec']} notarisations/s; headroom "
          f"{json.dumps({k: r['headroom_fraction'] for k, r in cap['resources'].items()})}; "
          f"{cap['sentence']}; alerts {json.dumps(alerts)}; {card}")
    print(f"telemetry (13a) wire (in-memory fabric, both endpoints): "
          f"{json.dumps(planes.wire.fabric.totals())}; {card}")
    print(f"telemetry (13c) planes on vs off, {TELEMETRY_PAIRS} interleaved pairs of the "
          f"{n}-spend flush: walls on {[round(x, 3) for x in ab['on']]} s, off "
          f"{[round(x, 3) for x in ab['off']]} s; min-of-walls overhead {100 * overhead:+.2f}% "
          f"(the reference's acceptance: 2%; not gated here: the host moves walls between "
          f"calls); {card}")
    _check_pool_answers(w["answers"], sub.labels[:len(picks)], ProfiledWorker.label)
    print(f"telemetry (13d) profiled worker (--profile-hz {TELEMETRY_PROFILE_HZ}): attached "
          f"{w['attach_s']:.3f} s after its start, {len(picks)} requests answered in "
          f"{w['wall_s']:.3f} s, every answer its label; SIGINT exit 0 in {w['stop_s']:.3f} s; "
          f"folded stacks {w['stacks']} lines, {w['samples']} samples, {w['bytes']} bytes; "
          f"{w['summary']}; {card}")
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in 13a-13c")
    print(f"telemetry (ph. 13) launches in 13a-13c: {json.dumps(launches)}; wall "
          f"{marks['13d']:.3f} s (ends of its steps "
          f"{json.dumps({k: round(v, 3) for k, v in marks.items()})} s); {card}")
    out.update(first_s=first_s, overhead=overhead, capacity=cap["binding_constraint"],
               worker=w, launches=launches, marks=marks)
    return out


# -- phase 14: the notary's serving-path planes ---------------------------------

PLANES_SPENDS = 4096         # 14a: the first phase-6 spends through QoS and the story (8,192 cut)
PLANES_EXPIRED_EVERY = 32    # 14a: 1 spend in 32 arrives with its deadline already past
PLANES_FLOOD_EVERY = 16      # 14a: 1 spend in 16 from the requester over its bucket
PLANES_CLIENTS = 240         # 14a: the other requesters (~15 spends each: inside the burst)
PLANES_POLICY = dict(target_p99_micros=10_000_000, max_batch=4096, max_wait_micros=300_000,
                     admission_rate_per_sec=50, admission_burst=64)   # 14a: sized for this card
PLANES_TIMED = 4096          # 14a: spends in the planes-on and the planes-off flush
DEFAULT_SPENDS = 256         # 14b: spends under QosPolicy()
DEFAULT_WAVES = 4            # 14b: arrival rounds, a tick after each
DURABLE_SPENDS = 2048        # 14c: spends admitted before the kill (4,096 cut)
DURABLE_SHARDS = 4           # 14c: the notary's shards and the commit log's partitions
NODE_PLANE_SPENDS = 256      # 14d: spends through the node's notary
PLANES_TIMEOUT = 120.0       # s any one drain may take before the phase fails


def _wait_micros(clock, micros: int) -> None:
    """Let `micros` pass on the notary's clock: a TestClock advances, the
    wall clock is slept on."""
    if hasattr(clock, "advance"):
        clock.advance(micros)
    else:
        time.sleep(micros / 1e6)


def _drain_ticks(svc, clock, label: str) -> int:
    """Tick a batching notary until its queue is empty, letting the
    controller's batching window pass whenever a tick holds; returns the
    ticks taken."""
    deadline, ticks = time.monotonic() + PLANES_TIMEOUT, 0
    while svc._pending:
        if time.monotonic() > deadline:
            raise RuntimeError(f"{label}: {len(svc._pending)} requests still queued")
        ticks += 1
        if not svc.tick():
            _wait_micros(clock, max(svc.effective_wait_micros, 1_000))
    return ticks


def _observe_flushes(qos) -> list:
    """The controller's readings after every flush it observes: (flush
    size, backlog, batch, wait µs, admitted p99 µs, brownout level)."""
    seen, observe = [], qos.observe_flush

    def observed(batch_size: int, backlog: int) -> None:
        observe(batch_size, backlog)
        seen.append((batch_size, backlog, qos.controller.batch, qos.controller.wait_micros,
                     round(qos.admitted_latency.quantile(0.99)), qos.brownout_level))

    qos.observe_flush = observed
    return seen


def _expected_kinds(labels: list, shed: set) -> list:
    """The answer each spend must get once the `shed` ones are gone: its
    label, but a double spend whose earlier spend was shed is accepted."""
    return ["ok" if k == "conflict" and i - 1 in shed else k for i, k in enumerate(labels)]


def _check_planes_answers(kinds: list, reasons: list, labels: list, allowed: set,
                          label: str) -> None:
    """Every spend answered once: as its label (a double spend of a shed
    spend accepted instead), or `shed` with one of the `allowed`
    reasons."""
    if len(kinds) != len(labels):
        raise RuntimeError(f"{label}: {len(kinds)} answers for {len(labels)} spends")
    shed = {i for i, k in enumerate(kinds) if k == "shed"}
    for i in sorted(shed):
        if reasons[i] not in allowed:
            raise RuntimeError(f"{label}: spend {i} shed for {reasons[i]!r}, not one of "
                               f"{sorted(allowed)}")
    want = _expected_kinds(labels, shed)
    bad = [i for i, k in enumerate(kinds) if i not in shed and k != want[i]]
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: {len(bad)} answers differ from their labels; spend {i} "
                           f"answered {kinds[i]}, label {want[i]}")


def _check_lifecycle(stories: list, tx_ids: list, kinds: list, reasons: list,
                     label: str, evicted: int = 0) -> None:
    """The story's lifecycle check: every spend that passed the notary
    check has exactly one story, closed by exactly one terminal event
    that agrees with its answer (a shed with its reason); a spend
    answered `wrong-notary` has none (it is answered before admission,
    as in the reference); no story is left open or was evicted."""
    from corda_tpu_torch.utils.txstory import TERMINALS, shed_reason

    if evicted:
        raise RuntimeError(f"{label}: {evicted} stories evicted: the ledger was too small")
    by_id = {s["tx_id"]: s for s in stories}
    terminal_names = set(TERMINALS.values())
    want_terminal = {"ok": "committed", "conflict": "rejected",
                     "invalid-signature": "rejected", "shed": "shed"}
    for tid, kind, reason in zip(tx_ids, kinds, reasons):
        s = by_id.get(tid)
        if kind == "wrong-notary":
            if s is not None:
                raise RuntimeError(f"{label}: {tid} answered wrong-notary has a story")
            continue
        if s is None:
            raise RuntimeError(f"{label}: no lifecycle story for submitted {tid} ({kind})")
        terms = [e["name"] for e in s["events"] if e["name"] in terminal_names]
        if len(terms) != 1:
            raise RuntimeError(f"{label}: {tid} recorded {len(terms)} terminal events {terms}")
        if s["terminal"] != want_terminal.get(kind):
            raise RuntimeError(f"{label}: {tid} answered {kind} but its story closed "
                               f"{s['terminal']!r}")
        if kind == "shed" and s["reason"] != shed_reason(reason):
            raise RuntimeError(f"{label}: {tid} shed for {reason} but its story says "
                               f"{s['reason']!r}")
    extra = set(by_id) - set(tx_ids)
    open_ = [s["tx_id"] for s in stories if s["terminal"] is None]
    if extra or open_:
        raise RuntimeError(f"{label}: {len(extra)} stories of no submission, {len(open_)} open")


def _shed_reason_of(answer):
    """The QoS reason behind a shed answer's message (qos.SHED_*)."""
    from corda_tpu_torch.node import qos as qoslib

    msg = getattr(answer, "message", "")
    if "already expired at arrival" in msg:
        return qoslib.SHED_EXPIRED_INGRESS
    if "expired while queued" in msg:
        return qoslib.SHED_EXPIRED_FLUSH
    if "admission rate" in msg:
        return qoslib.SHED_ADMISSION
    if "brownout" in msg:
        return qoslib.SHED_BROWNOUT_NO_DEADLINE
    return msg


def _check_same_as_plain(kinds: list, plain: dict, label: str) -> None:
    """Each admitted spend's answer equals a notary's without QoS over
    the same admitted spends (`plain`: index -> its answer kind)."""
    bad = [i for i, k in plain.items() if kinds[i] != k]
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: {len(bad)} admitted answers differ from the notary "
                           f"without QoS; spend {i}: {kinds[i]} against {plain[i]}")


def _planes_notary(fx, verifier, clock, qos=None, story=None, **kw):
    from corda_tpu_torch.node.notary import BatchingNotaryService, InMemoryUniquenessProvider
    from corda_tpu_torch.testing.notary_fixture import notary_hub

    hub = notary_hub(fx, verifier)
    hub.clock = clock
    svc = BatchingNotaryService(hub, kw.pop("uniqueness", None) or InMemoryUniquenessProvider(),
                                qos=qos, degraded_fallback=False, **kw)
    if story is not None:
        svc.attach_txstory(story)
    return svc


def _answers(started: list) -> tuple:
    from corda_tpu_torch.node.notary import finish_process
    from corda_tpu_torch.testing.notary_fixture import answer_kind

    answers = finish_process(started)
    return answers, [answer_kind(a) for a in answers], [_shed_reason_of(a) for a in answers]


def planes_qos(fx, verifier, clock, card: str) -> dict:
    """14a (module docstring): QoS and the story with PLANES_POLICY over
    the first PLANES_SPENDS spends, checked and reconciled; then the
    planes-on and planes-off flush of PLANES_TIMED spends."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.core.identity import Party
    from corda_tpu_torch.node import qos as qoslib
    from corda_tpu_torch.node.notary import run_process
    from corda_tpu_torch.utils.txstory import TxStory

    n = min(PLANES_SPENDS, len(fx.spends))
    spends, labels = fx.spends[:n], fx.labels[:n]
    # shed candidates never open a double-spend pair (its answer would change)
    free = [i for i in range(n) if labels[i] != "wrong-notary"
            and not (i + 1 < n and labels[i + 1] == "conflict")]
    expired = {i for i in free if i % PLANES_EXPIRED_EVERY == 5}
    flood = {i for i in free if i % PLANES_FLOOD_EVERY == 9} - expired
    key = fx.requester.owning_key
    flooder = Party("O=Flooder,L=London,C=GB", key)
    clients = [Party(f"O=Client{k},L=London,C=GB", key) for k in range(PLANES_CLIENTS)]
    who = [flooder if i in flood else clients[i % PLANES_CLIENTS] for i in range(n)]
    qos = qoslib.NotaryQos(qoslib.QosPolicy(**PLANES_POLICY), clock=clock)
    story = TxStory(clock=clock, max_open=2 * n, keep_done=2 * n)
    qos.txstory = story
    flushes = _observe_flushes(qos)
    svc = _planes_notary(fx, verifier, clock, qos, story,
                         max_batch=PLANES_POLICY["max_batch"],
                         max_wait_micros=PLANES_POLICY["max_wait_micros"])
    t0 = time.perf_counter()
    started = run_process([
        svc.process(stx, who[i], deadline=clock.now_micros() - 1 if i in expired else None)
        for i, stx in enumerate(spends)])
    t1 = time.perf_counter()
    ticks = _drain_ticks(svc, clock, "planes (14a)")
    _, kinds, reasons = _answers(started)
    wall = time.perf_counter() - t0
    allowed = {qoslib.SHED_EXPIRED_INGRESS, qoslib.SHED_EXPIRED_FLUSH, qoslib.SHED_ADMISSION,
               qoslib.SHED_BROWNOUT_BULK, qoslib.SHED_BROWNOUT_NO_DEADLINE}
    _check_planes_answers(kinds, reasons, labels, allowed, "planes (14a)")
    tids = [str(stx.id) for stx in spends]
    _check_lifecycle(story.stories(), tids, kinds, reasons, "planes (14a)", story.evicted)
    snap = qos.snapshot()
    by_reason = {r: reasons.count(r) for r in sorted({reasons[i] for i, k in enumerate(kinds)
                                                      if k == "shed"})}
    if snap["shed"] != by_reason or snap["admitted"] != n - kinds.count("shed") - kinds.count(
            "wrong-notary"):
        raise RuntimeError(f"planes (14a): Qos counters {snap['shed']}, admitted "
                           f"{snap['admitted']} do not reconcile with the answers {by_reason}")
    if [i for i in sorted(expired) if reasons[i] != qoslib.SHED_EXPIRED_INGRESS]:
        raise RuntimeError("planes (14a): a spend past its deadline at arrival was not shed")
    # the same admitted spends through a notary without QoS
    kept = [i for i, k in enumerate(kinds) if k != "shed"]
    plain_svc = _planes_notary(fx, verifier, clock, max_batch=len(kept) + 1)
    plain_started = run_process([plain_svc.process(spends[i], who[i]) for i in kept])
    plain_svc.flush()
    _, plain_kinds, _ = _answers(plain_started)
    _check_same_as_plain(kinds, dict(zip(kept, plain_kinds)), "planes (14a)")
    served = n - kinds.count("shed") - kinds.count("wrong-notary")
    print(f"planes (14a): {n} spends, {served} served in {wall:.3f} s = {served / wall:.1f} "
          f"notarisations/s (intake {t1 - t0:.3f} s, {ticks} ticks after it); admitted p99 "
          f"{qos.admitted_latency.quantile(0.99) / 1e3:.1f} ms; sheds {json.dumps(by_reason)} "
          f"({len(expired)} past their deadline, {len(flood)} from the flooder); brownout "
          f"transitions {qos.brownout_transitions}; every answer its label or a typed shed, "
          f"{len(kept)} equal to the notary without QoS, {len(story.stories())} stories "
          f"reconciled; {card}")
    for k, (size, backlog, batch, wait, p99, level) in enumerate(flushes):
        print(f"planes (14a) flush {k}: {size} served, backlog {backlog} -> controller batch "
              f"{batch}, wait {wait} us, admitted p99 {p99} us, brownout {level}")
    # one flush with the planes on and one with them off, a fresh decode each
    wire = [ser.encode(stx) for stx in spends[:min(PLANES_TIMED, n)]]
    walls = {}
    for mode in ("on", "off"):
        received = [ser.decode(b) for b in wire]
        if mode == "on":
            q = qoslib.NotaryQos(qoslib.QosPolicy(**PLANES_POLICY), clock=clock)
            s = TxStory(clock=clock, max_open=2 * n, keep_done=2 * n)
            q.txstory = s
            timed = _planes_notary(fx, verifier, clock, q, s, max_batch=len(wire),
                                   max_wait_micros=PLANES_POLICY["max_wait_micros"])
        else:
            timed = _planes_notary(fx, verifier, clock, max_batch=len(wire))
        ta = time.perf_counter()
        st = run_process([timed.process(stx, clients[i % PLANES_CLIENTS])
                          for i, stx in enumerate(received)])
        timed.flush()
        _, k2, _ = _answers(st)
        walls[mode] = time.perf_counter() - ta
        _check_planes_answers(k2, [None] * len(k2), fx.labels[:len(k2)], set(),
                              f"planes (14a) {mode}")
    print(f"planes (14a) one flush of {len(wire)}: planes on {walls['on']:.3f} s, off "
          f"{walls['off']:.3f} s ({(walls['on'] / walls['off'] - 1) * 100:+.1f}%, not gated); "
          f"{card}")
    return {"wall_s": wall, "rate": served / wall, "flushes": flushes, "sheds": by_reason,
            "walls": walls}


def planes_default(fx, verifier, clock, card: str) -> dict:
    """14b (module docstring): QosPolicy() over DEFAULT_SPENDS spends in
    DEFAULT_WAVES arrival rounds, reconciled as 14a."""
    from corda_tpu_torch.node import qos as qoslib
    from corda_tpu_torch.node.notary import run_process
    from corda_tpu_torch.utils.txstory import TxStory

    n = min(DEFAULT_SPENDS, len(fx.spends))
    spends, labels = fx.spends[:n], fx.labels[:n]
    qos = qoslib.NotaryQos(qoslib.QosPolicy(), clock=clock)
    story = TxStory(clock=clock, max_open=2 * n, keep_done=2 * n)
    qos.txstory = story
    flushes = _observe_flushes(qos)
    svc = _planes_notary(fx, verifier, clock, qos, story)
    wave = -(-n // DEFAULT_WAVES)
    started, t0 = [], time.perf_counter()
    for off in range(0, n, wave):
        started += run_process([svc.process(stx, fx.requester) for stx in spends[off:off + wave]])
        _wait_micros(clock, svc.effective_wait_micros)
        svc.tick()
    _drain_ticks(svc, clock, "planes (14b)")
    _, kinds, reasons = _answers(started)
    wall = time.perf_counter() - t0
    allowed = {qoslib.SHED_EXPIRED_FLUSH, qoslib.SHED_BROWNOUT_NO_DEADLINE}
    _check_planes_answers(kinds, reasons, labels, allowed, "planes (14b)")
    _check_lifecycle(story.stories(), [str(s.id) for s in spends], kinds, reasons,
                     "planes (14b)", story.evicted)
    by_kind = {k: kinds.count(k) for k in sorted(set(kinds))}
    for k, (size, backlog, batch, wait, p99, level) in enumerate(flushes):
        print(f"planes (14b) QosPolicy() flush {k}: {size} served, backlog {backlog} -> "
              f"controller batch {batch}, wait {wait} us, admitted p99 {p99} us, brownout "
              f"{level}")
    print(f"planes (14b) QosPolicy(): {n} spends in {wall:.3f} s, {len(flushes)} flushes; "
          f"settled batch {qos.controller.batch}, wait {qos.controller.wait_micros} us, "
          f"brownout {qos.brownout_level}; answers {json.dumps(by_kind)}; stories reconciled; "
          f"{card}")
    return {"wall_s": wall, "flushes": flushes, "answers": by_kind}


def _reopen_durable(tmp: str):
    from corda_tpu_torch.node.persistence import NodeDatabase, NotaryIntentJournal
    from corda_tpu_torch.node.statestore import ShardedCommitLogUniquenessProvider

    db = NodeDatabase(os.path.join(tmp, "notary.db"))
    store = ShardedCommitLogUniquenessProvider(os.path.join(tmp, "statestore"),
                                               DURABLE_SHARDS)
    return db, store, NotaryIntentJournal(db)


def _check_replay(replayed: list, journaled: list, kinds: dict, labels: dict, label: str) -> None:
    """Every journaled spend replayed exactly once and answered as its
    label (`kinds`, `labels`: tx id -> kind)."""
    ids = [str(tx) for _seq, tx, _fut in replayed]
    if sorted(ids) != sorted(journaled) or len(set(ids)) != len(ids):
        raise RuntimeError(f"{label}: {len(ids)} intents replayed ({len(set(ids))} distinct) "
                           f"for {len(journaled)} journaled")
    bad = [t for t in ids if kinds.get(t) != labels[t]]
    if bad:
        raise RuntimeError(f"{label}: {len(bad)} replayed spends answered unlike their labels; "
                           f"{bad[0]}: {kinds.get(bad[0])}, label {labels[bad[0]]}")


def planes_durable(fx, verifier, clock, root: str, card: str) -> dict:
    """14c (module docstring): the intent WAL and the commit-log store
    across a kill, replayed on the card; the committed map against
    sqlite's, across compaction, reopen and migration."""
    from corda_tpu_torch.node.notary import run_process
    from corda_tpu_torch.node.persistence import NodeDatabase, PersistentUniquenessProvider
    from corda_tpu_torch.node.statestore import (
        ShardedCommitLogUniquenessProvider,
        migrate_sqlite_state,
    )
    from corda_tpu_torch.testing.notary_fixture import answer_kind

    n = min(DURABLE_SPENDS, len(fx.spends))
    spends, labels = fx.spends[:n], fx.labels[:n]
    label_of = {str(s.id): k for s, k in zip(spends, labels)}
    tmp = os.path.join(root, "durable")
    os.makedirs(tmp)
    t0 = time.perf_counter()
    db, store, journal = _reopen_durable(tmp)
    svc = _planes_notary(fx, verifier, clock, uniqueness=store, shards=DURABLE_SHARDS,
                         max_batch=n, shard_queue_depth=n, intent_journal=journal)
    started = run_process([svc.process(stx, fx.requester) for stx in spends])
    at_entry = [a for a in started if not isinstance(a, tuple)]
    journaled = [str(stx.id) for stx, a in zip(spends, started) if isinstance(a, tuple)]
    if journal.unresolved_count != len(journaled) or svc.backlog() != len(journaled):
        raise RuntimeError(f"planes (14c): {journal.unresolved_count} intents journaled, "
                           f"{svc.backlog()} queued, for {len(journaled)} admitted")
    # the kill: the notary dropped before its flush, the database closed
    # without the buffered deletes
    del svc, started
    journal.lose_unflushed_resolutions()
    store.close()
    db.close()
    t1 = time.perf_counter()
    replays, maps = [], []
    for attempt in ("replay", "replay again"):
        db, store, journal = _reopen_durable(tmp)
        svc = _planes_notary(fx, verifier, clock, uniqueness=store, shards=DURABLE_SHARDS,
                             max_batch=n, shard_queue_depth=n, intent_journal=journal)
        ta = time.perf_counter()
        replayed = svc.replay_intents()
        svc.flush()
        replay_s = time.perf_counter() - ta
        kinds = {str(tx): answer_kind(fut.result()) for _seq, tx, fut in replayed}
        _check_replay(replayed, journaled, kinds, label_of, f"planes (14c) {attempt}")
        replays.append(replay_s)
        maps.append(dict(store.committed))
        # a second kill before the deletes reach the WAL: every intent
        # replays again, and the same-tx re-commit absorbs the committed
        journal.lose_unflushed_resolutions()
        store.close()
        db.close()
    _maps_equal(maps, "planes (14c) replays")
    committed = maps[0]
    # the same spends through sqlite: PersistentUniquenessProvider's map
    sdb = NodeDatabase(os.path.join(tmp, "sqlite.db"))
    sqlite = PersistentUniquenessProvider(sdb)
    entries = [(list(s.wtx.inputs), s.id, fx.requester) for s, k in zip(spends, labels)
               if k in ("ok", "conflict")]
    outcomes = sqlite.commit_many(entries)
    again = sqlite.commit_many([e for e, o in zip(entries, outcomes) if o is None])
    if any(o is not None for o in again):
        raise RuntimeError("planes (14c): sqlite refused a same-transaction re-commit")
    rows = sdb.query("SELECT ref_tx, ref_index, consumer FROM notary_commits")
    plain = {(bytes(r.txhash.bytes_), r.index): bytes(t.bytes_) for r, t in committed.items()}
    sqlite_map = {(bytes(t), i): bytes(c) for t, i, c in rows}
    if plain != sqlite_map:
        raise RuntimeError(f"planes (14c): the commit log holds {len(plain)} refs, sqlite "
                           f"{len(sqlite_map)}; the maps differ")
    # compaction, reopen, migration
    db, store, journal = _reopen_durable(tmp)
    if journal.unresolved_count != len(journaled):
        raise RuntimeError("planes (14c): the WAL lost intents across the kills")
    store.compact_all()
    stats = store.stats()
    store.close()
    db.close()
    db, store, journal = _reopen_durable(tmp)
    reopened = dict(store.committed)
    store.close()
    db.close()
    migrated = ShardedCommitLogUniquenessProvider(os.path.join(tmp, "migrated"), DURABLE_SHARDS)
    moved = migrate_sqlite_state(sdb, migrated)
    _maps_equal([committed, reopened, dict(migrated.committed)],
                "planes (14c) compaction, reopen and migration")
    migrated.close()
    sdb.close()
    wall = time.perf_counter() - t0
    print(f"planes (14c): {len(journaled)} spends journaled ({len(at_entry)} answered at entry), "
          f"the notary killed before its flush ({t1 - t0:.3f} s); replayed into one flush on "
          f"the card in {replays[0]:.3f} s, each answered once as its label; killed again "
          f"before the deletes and replayed in {replays[1]:.3f} s, the same answers; the "
          f"commit log's {len(committed)} refs equal sqlite's, after compaction "
          f"({stats['compactions']} folds, {stats['segments']} segments), reopen and "
          f"migration ({moved} rows); wall {wall:.3f} s; {card}")
    return {"wall_s": wall, "replay_s": replays, "refs": len(committed)}


def _seed_identity(base: str, keypair) -> None:
    """Provision a node directory with `keypair` as its identity, as an
    operator's key import does: the fixture's spends name that notary."""
    from corda_tpu_torch.node.persistence import NodeDatabase, PersistentKVStore

    os.makedirs(base, exist_ok=True)
    db = NodeDatabase(os.path.join(base, "node.db"))
    PersistentKVStore(db, "node_identity").put(
        b"private", keypair.private.scheme_id.to_bytes(4, "big") + keypair.private.data)
    db.close()


def _check_node_planes(node, spends: list, kinds: list, label: str) -> None:
    """14d's reading after a pump tick: every admitted spend's story in
    the TxStoryIndex with its terminal, the QoS and txstory rules on the
    health monitor, no plane left out, the WAL drained and the commit
    log holding the accepted spends' inputs."""
    from corda_tpu_torch.utils.txstory import TERMINALS

    want = {"ok": TERMINALS["committed"], "conflict": TERMINALS["rejected"],
            "invalid-signature": TERMINALS["rejected"]}
    if node.unported_planes != ():
        raise RuntimeError(f"{label}: planes left out: {node.unported_planes}")
    for stx, kind in zip(spends, kinds):
        if kind == "wrong-notary":
            continue
        names = [e["name"] for e in node.txstory.index.events_for(str(stx.id))]
        if want.get(kind) not in names or "notary.admit" not in names:
            raise RuntimeError(f"{label}: TxStoryIndex holds {names} for {stx.id} ({kind})")
    alerts = set(node.health.snapshot()["alerts"])
    if not {"slo.burn_rate", "qos.shed_ratio", "txstory.stage_slo"} <= alerts:
        raise RuntimeError(f"{label}: the health monitor carries {sorted(alerts)}")
    svc = node.services.notary_service
    if svc.intent_journal.unresolved_count:
        raise RuntimeError(f"{label}: {svc.intent_journal.unresolved_count} intents unresolved")
    if node.statestore.committed_count != kinds.count("ok"):
        raise RuntimeError(f"{label}: the commit log holds {node.statestore.committed_count} "
                           f"refs for {kinds.count('ok')} accepted spends")


def planes_node(fx, verifier, root: str, card: str) -> dict:
    """14d (module docstring): one in-process Node from node.toml with
    every plane, NODE_PLANE_SPENDS spends through its notary."""
    from corda_tpu_torch.node.config import NodeConfig, load_config, write_config
    from corda_tpu_torch.node.node import Node
    from corda_tpu_torch.node.notary import run_process

    n = min(NODE_PLANE_SPENDS, len(fx.spends))
    spends, labels = fx.spends[:n], fx.labels[:n]
    base = os.path.join(root, "node")
    _seed_identity(base, fx.notary_key)
    toml = os.path.join(root, "node.toml")
    write_config(NodeConfig(name=fx.notary.name, base_dir=base, notary="batching",
                            qos_enabled=True, notary_intent_wal=True,
                            notary_state_store="commitlog", txstory_enabled=True,
                            txstory_index=True, txstory_stage_slo_micros=10_000_000,
                            use_tls=False), toml)
    t0 = time.perf_counter()
    node = Node(load_config(toml), batch_verifier=verifier).start()
    try:
        boot_s = time.perf_counter() - t0
        if node.party != fx.notary:
            raise RuntimeError("planes (14d): the node booted as another notary")
        for party in (fx.bank, fx.requester, fx.other_notary):
            node.services.identity.register(party)
        node.services.record_transactions(fx.issues)
        svc = node.services.notary_service
        t1 = time.perf_counter()
        started = run_process([svc.process(stx, fx.requester) for stx in spends])
        deadline = time.monotonic() + PLANES_TIMEOUT
        while any(isinstance(a, tuple) and not a[1].done for a in started):
            if time.monotonic() > deadline:
                raise RuntimeError("planes (14d): the node's notary left requests unanswered")
            node.pump(timeout=0.01)
        _, kinds, reasons = _answers(started)
        serve_s = time.perf_counter() - t1
        node.pump()
        _check_planes_answers(kinds, reasons, labels, set(), "planes (14d)")
        _check_node_planes(node, spends, kinds, "planes (14d)")
        snap = node.qos.snapshot()
        print(f"planes (14d): a node from node.toml with every plane (unported_planes "
              f"{node.unported_planes}) booted in {boot_s:.3f} s; {n} spends through its "
              f"notary in {serve_s:.3f} s, every answer its label; TxStoryIndex "
              f"{node.txstory.index.row_count} rows, each story's terminal in it; controller "
              f"batch {snap['controller']['batch']}, wait {snap['controller']['wait_micros']} "
              f"us; commit log {node.statestore.stats()['committed_states']} refs; {card}")
    finally:
        node.stop()
    return {"boot_s": boot_s, "serve_s": serve_s}


def phase_planes(device, card: str, fx, clock=None) -> dict:
    """Phase 14 (module docstring); returns its walls and the launches of
    14a-14d. `clock` is the CPU rehearsal's TestClock (the notary's
    clock; the wall clock by default)."""
    import tempfile

    from corda_tpu_torch.node.services import Clock

    clock = clock or Clock()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "corda_tpu_torch")
    os.makedirs(scratch, exist_ok=True)
    verifier = _recording_verifier((CHUNK,), device)
    t_phase = time.perf_counter()
    _zero_counters()
    walls = {}
    with tempfile.TemporaryDirectory(dir=scratch, prefix="planes-") as tmp:
        t0 = time.perf_counter()
        qos = planes_qos(fx, verifier, clock, card)
        walls["14a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        planes_default(fx, verifier, clock, card)
        walls["14b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        planes_durable(fx, verifier, clock, tmp, card)
        walls["14c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        planes_node(fx, verifier, tmp, card)
        walls["14d"] = time.perf_counter() - t0
    launches = _read_counters()
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in the planes phase")
    wall = time.perf_counter() - t_phase
    print(f"planes (ph. 14) launches: {json.dumps(launches)}; walls "
          f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}; wall {wall:.3f} s; "
          f"{card}")
    return {"launches": launches, "walls": walls, "wall_s": wall, "rate": qos["rate"]}


XSHARD_MEMBERS = ("N0", "N1", "N2")   # 15: the cross-shard cluster's members
XSHARD_PARTITIONS = 6        # 15: partitions of the state-ref space (two per member)
XSHARD_SPENDS = 2048         # 15a: the first phase-6 spends, round robin over the members (4,096 cut)
XSHARD_FAULT_SPENDS = 96     # 15b: "ok" spends after 15a's through the partition
XSHARD_KILL_SPENDS = 64      # 15b: "ok" spends whose coordinator is killed after deciding
XSHARD_POLICY = dict(timeout_micros=1_000_000, reservation_ttl_micros=1_000_000)
XSHARD_STEP = 100_000        # µs the cluster's TestClock advances per fabric round
XSHARD_ROUNDS = 400          # fabric rounds any one drive may take before the phase fails
XSHARD_TOP_LOCKS = 5         # 15c: the most contended locks printed


class _XShardCluster:
    """Phase 15's cluster (module docstring): a BatchingNotaryService per
    member over a DistributedUniquenessProvider, one in-memory fabric and
    TestClock, and per member one sqlite database holding its committed
    rows, coordinator WAL, reservation journal and intent WAL; every
    member's notary dispatches to the one shared verifier."""

    def __init__(self, fx, verifier, root: str):
        from corda_tpu_torch.node.distributed_uniqueness import XShardPolicy
        from corda_tpu_torch.node.messaging import FabricFaults, InMemoryMessagingNetwork
        from corda_tpu_torch.node.notary import BatchingNotaryService
        from corda_tpu_torch.node.persistence import NodeDatabase, NotaryIntentJournal
        from corda_tpu_torch.node.services import TestClock
        from corda_tpu_torch.testing.notary_fixture import notary_hub

        self.fx, self.verifier = fx, verifier
        self.clock = TestClock()
        self.faults = FabricFaults(clock=self.clock)
        self.net = InMemoryMessagingNetwork(clock=self.clock, faults=self.faults)
        self.policy = XShardPolicy(**XSHARD_POLICY)
        self.decisions: list = []
        self.monitors: list = []
        self.dbs = {m: NodeDatabase(os.path.join(root, f"{m}.db")) for m in XSHARD_MEMBERS}
        self.provs = {m: self.provider(m) for m in XSHARD_MEMBERS}
        self.shard_map = self.provs[XSHARD_MEMBERS[0]].shard_map
        self.svcs = {m: BatchingNotaryService(notary_hub(fx, verifier), self.provs[m],
                                              max_batch=10**6, degraded_fallback=False,
                                              intent_journal=NotaryIntentJournal(self.dbs[m]))
                     for m in XSHARD_MEMBERS}

    def provider(self, member: str):
        """`member`'s provider over its database (a restart builds it again)."""
        from corda_tpu_torch.node.distributed_uniqueness import DistributedUniquenessProvider
        from corda_tpu_torch.node.persistence import (
            ShardedPersistentUniquenessProvider,
            XShardCoordinatorJournal,
            XShardReservationJournal,
        )

        db = self.dbs[member]
        return DistributedUniquenessProvider(
            member, XSHARD_MEMBERS, self.net.endpoint(member), self.clock,
            n_partitions=XSHARD_PARTITIONS,
            store=ShardedPersistentUniquenessProvider(db, XSHARD_PARTITIONS),
            journal=XShardCoordinatorJournal(db), reservations=XShardReservationJournal(db),
            policy=self.policy, seed=XSHARD_MEMBERS.index(member), decision_log=self.decisions)

    def owner(self, stx) -> str:
        return self.shard_map.owner_of(stx.wtx.inputs[0])

    def quiescent(self) -> bool:
        return self.net.deliverable == 0 and all(
            p.in_flight_count() == 0 and p.reservation_count() == 0
            for p in self.provs.values())

    def drive(self, done, label: str) -> int:
        """Fabric rounds (deliver, tick every provider and monitor, advance
        the clock) until `done()`; returns the rounds taken."""
        for rounds in range(XSHARD_ROUNDS):
            if done():
                return rounds
            self.net.run()
            for p in self.provs.values():
                p.tick()
            for monitor in self.monitors:
                monitor.tick()
            self.clock.advance(XSHARD_STEP)
        raise RuntimeError(f"{label}: not settled in {XSHARD_ROUNDS} fabric rounds")

    def serve(self, spends: list, coordinators: list, label: str) -> tuple:
        """Each spend through its coordinator's `process`, one flush per
        member, then fabric rounds until every answer is in and the
        cluster is quiescent; returns (answers, kinds, card calls, wall)."""
        from corda_tpu_torch.node.notary import finish_process, run_process
        from corda_tpu_torch.testing.notary_fixture import answer_kind

        calls0 = len(self.verifier.calls)
        t0 = time.perf_counter()
        started, order = {}, {}
        for m in XSHARD_MEMBERS:
            order[m] = [i for i, c in enumerate(coordinators) if c == m]
            started[m] = run_process([self.svcs[m].process(spends[i], self.fx.requester)
                                      for i in order[m]])
        for m in XSHARD_MEMBERS:
            if order[m]:
                self.svcs[m].flush()

        def answered():
            return all(not isinstance(e, tuple) or e[1].done
                       for entries in started.values() for e in entries)

        self.drive(lambda: answered() and self.quiescent(), label)
        answers = [None] * len(spends)
        for m in XSHARD_MEMBERS:
            for i, answer in zip(order[m], finish_process(started[m])):
                answers[i] = answer
        wall = time.perf_counter() - t0
        calls = len(self.verifier.calls) - calls0
        for svc in self.svcs.values():
            svc.tick()   # the intent WAL's group-committed deletes
        return answers, [answer_kind(a) for a in answers], calls, wall

    def close(self) -> None:
        for p in self.provs.values():
            p.stop()
        for db in self.dbs.values():
            db.close()


def _check_xshard_answers(kinds: list, single: list, spends: list, label: str) -> None:
    """Every member's answer as the single notary's for the same spend,
    but that either rival of a double spend may win."""
    from corda_tpu_torch.testing.notary_fixture import rival_free_mismatches

    bad = rival_free_mismatches(kinds, single, spends)
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: {len(bad)} answers differ from the single notary's; "
                           f"spend {i} got {kinds[i]!r}, the single notary {single[i]!r}")


def _check_consumed_once(committed: dict, shard_map, spends: list, kinds: list,
                         label: str) -> dict:
    """Each input committed at its owner only, to at most one spend, and
    every accepted spend's input to that spend; returns the merged map."""
    merged: dict = {}
    for member, rows in committed.items():
        for ref, tx in rows.items():
            if shard_map.owner_of(ref) != member:
                raise RuntimeError(f"{label}: {member} holds {ref}, owned by "
                                   f"{shard_map.owner_of(ref)}")
            if merged.setdefault(ref, tx) != tx:
                raise RuntimeError(f"{label}: {ref} consumed twice")
    for stx, kind in zip(spends, kinds):
        got = merged.get(stx.wtx.inputs[0])
        if (kind == "ok") != (got == stx.id):
            raise RuntimeError(f"{label}: spend {stx.id} answered {kind!r} but its input is "
                               f"committed to {got}")
    return merged


def _check_serial_replay(decisions: list, refs_of: dict, merged: dict, label: str) -> None:
    """The decision log, replayed serially over one map, makes every
    logged decision (accepts, and conflicts naming the serial winner) and
    ends at the merged committed map."""
    serial: dict = {}
    for tx, conflict in decisions:
        refs = refs_of.get(tx)
        if refs is None:
            raise RuntimeError(f"{label}: the decision log names an unknown transaction {tx}")
        want = {r: serial[r] for r in refs if r in serial and serial[r] != tx}
        if conflict is None:
            if want:
                raise RuntimeError(f"{label}: the log accepts {tx} where a serial replay "
                                   f"conflicts on {sorted(map(str, want))}")
            for r in refs:
                serial[r] = tx
        elif dict(conflict) != want:
            raise RuntimeError(f"{label}: the log's conflict set for {tx} is not the serial "
                               "replay's")
    if serial != merged:
        raise RuntimeError(f"{label}: the serial replay ({len(serial)} refs) is not the merged "
                           f"committed map ({len(merged)} refs)")


def _check_xshard_quiescent(cluster, label: str) -> None:
    """No reservation, orphan, in-flight transaction or unresolved
    coordinator, reservation or intent WAL row on any member."""
    for m, p in cluster.provs.items():
        left = {"reservations": p.reservation_count(), "orphans": p.orphan_count(),
                "in flight": p.in_flight_count(), "WAL rows": p.journal.unresolved_count,
                "journaled holds": p.reservations.held_count,
                "intent rows": cluster.svcs[m].intent_journal.unresolved_count}
        left = {k: v for k, v in left.items() if v}
        if left:
            raise RuntimeError(f"{label}: {m} is not quiescent: {left}")


def xshard_single(fx, verifier, root: str) -> list:
    """15a's reference: a single batching notary over a durable
    PersistentUniquenessProvider on 15a's spends; returns its answer
    kinds."""
    from corda_tpu_torch.node.notary import finish_process, run_process
    from corda_tpu_torch.node.persistence import NodeDatabase
    from corda_tpu_torch.testing.notary_fixture import answer_kind, notary_hub

    n = min(XSHARD_SPENDS, len(fx.spends))
    single_db = NodeDatabase(os.path.join(root, "single.db"))
    single = _durable_notary(notary_hub(fx, verifier), _durable_provider(single_db, 1), 1, n)
    started = run_process([single.process(s, fx.requester) for s in fx.spends[:n]])
    single.flush()
    single_kinds = [answer_kind(a) for a in finish_process(started)]
    single_db.close()
    if single_kinds != fx.labels[:n]:
        raise RuntimeError("xshard (15a): the single notary's answers differ from the labels")
    return single_kinds


def xshard_serve(fx, verifier, root: str, single_kinds: list, card: str) -> tuple:
    """15a (module docstring), held to `single_kinds`; returns the
    cluster, still up, for 15b."""
    n = len(single_kinds)
    spends = fx.spends[:n]
    cluster = _XShardCluster(fx, verifier, root)
    coordinators = [XSHARD_MEMBERS[i % len(XSHARD_MEMBERS)] for i in range(n)]
    cross = sum(c != cluster.owner(s) for c, s in zip(coordinators, spends))
    _, kinds, calls, wall = cluster.serve(spends, coordinators, "xshard (15a)")
    if calls < len(XSHARD_MEMBERS):
        raise RuntimeError(f"xshard (15a): the member flushes made {calls} card calls, fewer "
                           f"than one per member ({len(XSHARD_MEMBERS)})")
    _check_xshard_answers(kinds, single_kinds, spends, "xshard (15a)")
    swapped = sum(k != s for k, s in zip(kinds, single_kinds))
    committed = {m: dict(p.store.committed) for m, p in cluster.provs.items()}
    merged = _check_consumed_once(committed, cluster.shard_map, spends, kinds, "xshard (15a)")
    _check_serial_replay(cluster.decisions, {s.id: list(s.wtx.inputs) for s in spends},
                         merged, "xshard (15a)")
    _check_xshard_quiescent(cluster, "xshard (15a)")
    rows = sum(len(reqs) for reqs, _ in verifier.calls[-calls:]) if calls else 0
    print(f"xshard (15a): {n} spends over {len(XSHARD_MEMBERS)} members "
          f"({XSHARD_PARTITIONS} partitions), {cross} cross-member; every answer the single "
          f"notary's (double spends won by the other rival: {swapped // 2}); each input "
          f"consumed at most once; the decision log ({len(cluster.decisions)} decisions) "
          f"replays serially to the merged map ({len(merged)} refs); 0 reservations, 0 "
          f"orphans, 0 WAL rows; {n / wall:.1f} notarisations/s ({wall:.3f} s); the member "
          f"flushes' card calls {calls} ({rows} rows); {card}")
    return cluster, {"rate": n / wall, "calls": calls, "cross": cross}


def _spread(cluster, spends: list, n: int) -> list:
    """`n` of `spends` ordered so that round robin over the members
    coordinates each (coordinator, owner) pair equally often (a fixture's
    spends of one issue share its partition)."""
    k = len(XSHARD_MEMBERS)
    by_owner = {m: iter([s for s in spends if cluster.owner(s) == m]) for m in XSHARD_MEMBERS}
    out = [next(by_owner[XSHARD_MEMBERS[(i - i // k) % k]], None) for i in range(n)]
    if None in out:
        raise RuntimeError(f"xshard (15b): fewer than {n // k} spends per owner")
    return out


def xshard_partition(cluster, spends: list, card: str) -> dict:
    """15b's partition: the last member cut off past the reserve timeout,
    then healed and the unavailable spends retried."""
    from corda_tpu_torch.utils.health import HealthMonitor

    cut = XSHARD_MEMBERS[-1]
    monitor = HealthMonitor(clock=cluster.clock)
    cluster.provs[XSHARD_MEMBERS[0]].attach_health(monitor)
    cluster.monitors.append(monitor)
    coordinators = [XSHARD_MEMBERS[i % len(XSHARD_MEMBERS)] for i in range(len(spends))]
    want = ["ok" if (c == cut) == (cluster.owner(s) == cut) else "shard-unavailable"
            for c, s in zip(coordinators, spends)]
    cluster.faults.partition(set(XSHARD_MEMBERS[:-1]), {cut})
    _, kinds, _, wall = cluster.serve(spends, coordinators, "xshard (15b) partition")
    if kinds != want:
        raise RuntimeError(f"xshard (15b): {sum(k != w for k, w in zip(kinds, want))} answers "
                           "under the partition are not shard-unavailable exactly for the "
                           "spends across it")
    alert = monitor.snapshot()["alerts"].get("shard.unreachable", {})
    if alert.get("state") != "firing":
        raise RuntimeError(f"xshard (15b): shard.unreachable is {alert.get('state')!r} under "
                           "the partition")
    cluster.faults.heal()
    retry = [i for i, k in enumerate(kinds) if k == "shard-unavailable"]
    _, again, _, wall2 = cluster.serve([spends[i] for i in retry],
                                       [coordinators[i] for i in retry], "xshard (15b) retry")
    cluster.drive(lambda: not any(p.unreachable_owners() for p in cluster.provs.values()),
                  "xshard (15b) heal")
    monitor.tick()
    state = monitor.snapshot()["alerts"]["shard.unreachable"]["state"]
    if set(again) != {"ok"} or state == "firing":
        raise RuntimeError(f"xshard (15b): after the heal the retries answered "
                           f"{sorted(set(again))} and shard.unreachable is {state!r}")
    _check_xshard_quiescent(cluster, "xshard (15b) partition")
    print(f"xshard (15b) partition: {cut} cut off for {wall:.3f} s: {len(retry)} of "
          f"{len(spends)} spends shard-unavailable (exactly those across it), "
          f"shard.unreachable fired; healed: the retries signed in {wall2:.3f} s and the alert "
          f"is {state}; {card}")
    return {"unavailable": len(retry)}


def xshard_kill(cluster, spends: list, card: str) -> dict:
    """15b's kill: a coordinator's spends decided (the WAL's commit marks
    durable, every answer in), their ShardCommits lost with the kill
    (dropped on the wire, so no owner holds a row); the coordinator built
    again over its database, recover()."""
    from corda_tpu_torch.node.notary import finish_process, run_process
    from corda_tpu_torch.testing.notary_fixture import answer_kind

    coord = XSHARD_MEMBERS[0]
    picks = [s for s in spends if cluster.owner(s) != coord][:XSHARD_KILL_SPENDS]
    svc = cluster.svcs[coord]
    started = run_process([svc.process(s, cluster.fx.requester) for s in picks])
    svc.flush()
    cluster.net.pump(len(picks))   # every ShardReserve to its owner
    cluster.net.pump(len(picks))   # every ack back: each decided, its ShardCommit queued
    kinds = [answer_kind(a) for a in finish_process(started)]
    journal = cluster.provs[coord].journal
    if set(kinds) != {"ok"} or journal.unresolved_count != len(picks):
        raise RuntimeError(f"xshard (15b) kill: before the kill {sorted(set(kinds))} answers "
                           f"and {journal.unresolved_count} WAL rows for {len(picks)} spends")
    others = [m for m in XSHARD_MEMBERS if m != coord]
    for m in others:
        cluster.faults.drop_link(coord, m, 1.0, symmetric=False)
    lost = cluster.net.run()
    for m in others:
        cluster.faults.drop_link(coord, m, 0, symmetric=False)
    held = [s.id for s in picks
            if cluster.provs[cluster.owner(s)].store.committed.get(s.wtx.inputs[0]) == s.id]
    if held:
        raise RuntimeError(f"xshard (15b) kill: {len(held)} owners hold their rows before the "
                           "recovery")
    cluster.provs[coord].stop()
    cluster.provs[coord] = cluster.provider(coord)
    recovered = cluster.provs[coord].recover()
    rounds = cluster.drive(
        lambda: cluster.quiescent() and cluster.provs[coord].journal.unresolved_count == 0,
        "xshard (15b) recovery")
    missing = [s.id for s in picks
               if cluster.provs[cluster.owner(s)].store.committed.get(s.wtx.inputs[0]) != s.id]
    if recovered != len(picks) or missing:
        raise RuntimeError(f"xshard (15b) kill: recover() re-drove {recovered} of {len(picks)} "
                           f"and {len(missing)} owners lack their rows")
    _check_xshard_quiescent(cluster, "xshard (15b) kill")
    print(f"xshard (15b) kill: {coord} killed after deciding {len(picks)} cross-member spends "
          f"(answered; {lost} frames lost with it, no owner holding a row); recover() re-drove {recovered} to "
          f"completion in {rounds} fabric rounds, every owner holds the rows; {card}")
    return {"recovered": recovered}


def xshard_soak(verifier, card: str) -> dict:
    """15c: testing/sanitizer.standard_soak armed, on `verifier`."""
    from corda_tpu_torch.testing.sanitizer import ConcurrencySanitizer, standard_soak

    san = ConcurrencySanitizer()
    with san:
        out = standard_soak(batch_verifier=verifier)
    bad = san.findings(("sanitizer-lock-cycle", "sanitizer-self-deadlock"))
    if bad or not out["signed"] or not out["rejected"]:
        raise RuntimeError(f"xshard (15c): soak {out}, findings "
                           f"{[f.detail for f in bad]}")
    stats = san.lock_stats()
    top = sorted(stats.items(), key=lambda kv: (-kv[1]["contended"], -kv[1]["hold_us_total"]))
    print(f"xshard (15c): armed standard_soak on the phase's verifier: {out}, {len(stats)} locks, "
          f"{len(san.graph())} order edges, 0 lock-order inversions, 0 self-deadlocks; {card}")
    for name, st in top[:XSHARD_TOP_LOCKS]:
        print(f"xshard (15c) lock {name}: {st['acquisitions']} acquisitions, "
              f"{st['contended']} contended, hold mean {st['hold_us_mean']} µs, max "
              f"{st['hold_us_max']} µs, total {st['hold_us_total']} µs")
    return {"locks": len(stats), "top": [name for name, _ in top[:XSHARD_TOP_LOCKS]]}


def phase_xshard(device, card: str, fx) -> dict:
    """Phase 15 (module docstring); returns its walls and the launches of
    15a-15c."""
    import tempfile

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "corda_tpu_torch")
    os.makedirs(scratch, exist_ok=True)
    verifier = _recording_verifier((CHUNK,), device)
    t_phase = time.perf_counter()
    walls = {}
    later = [fx.spends[i] for i in range(XSHARD_SPENDS, len(fx.spends)) if fx.labels[i] == "ok"]
    with tempfile.TemporaryDirectory(dir=scratch, prefix="xshard-") as tmp:
        t0 = time.perf_counter()
        _zero_counters()
        single_kinds = xshard_single(fx, verifier, tmp)
        single_launches = _read_counters()
        _zero_counters()   # from here on, the cluster's and the soak's launches only
        cluster, served = xshard_serve(fx, verifier, tmp, single_kinds, card)
        walls["15a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            fault = _spread(cluster, later, XSHARD_FAULT_SPENDS)
            xshard_partition(cluster, fault, card)
            xshard_kill(cluster, [s for s in later if s not in fault], card)
        finally:
            cluster.close()
        walls["15b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xshard_soak(verifier, card)
    walls["15c"] = time.perf_counter() - t0
    launches = _read_counters()
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in the xshard phase")
    wall = time.perf_counter() - t_phase
    print(f"xshard (ph. 15) launches: {json.dumps(launches)} (15a's single reference "
          f"notary, apart: {json.dumps(single_launches)}); walls "
          f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}; wall {wall:.3f} s; "
          f"{card}")
    return {"launches": launches, "walls": walls, "wall_s": wall, "rate": served["rate"]}


# -- phase 16: the web gateway, the shell, the replacement flows, the doorman --

WEB_PAYMENTS = 3             # 16a: POST /api/cash/pay payments to Hub, one per payer (8 cut)
WEB_BATCH_WAIT = 50_000      # 16a: µs the hub's batching notary holds a flush open
WEB_TIMEOUT = 180.0          # s any one request or drive step may take before the phase fails
WEB_SETTLE = 10.0            # s the gateway accounting or the /cluster rollup may take to settle
WEB_CORDAPPS = ("corda_tpu.finance", "corda_tpu.finance.web")
# GET routes every gateway serves as JSON; a payer answers the notary's
# planes (QoS, the state store, the shard map) with the reference's 404
WEB_PLANES = ("/", "/perf", "/device", "/capacity", "/wire", "/qos", "/tx/slowest",
              "/statestore", "/shards", "/health", "/healthz", "/traces", "/incidents",
              "/api/status", "/api/network", "/api/notaries", "/api/vault", "/api/flows",
              "/api/plugins", "/api/explorer/dashboard", "/api/explorer/states",
              "/api/explorer/network", "/api/explorer/vault", "/api/explorer/machines")
NOTARY_PLANES = ("/qos", "/statestore", "/shards")
REPLACE_SEED = 23            # 16c: MockNetwork's seed
# 16a over verifier_backend = "cpu" in a child process; argv[1] is its root
WEB_CPU_DRIVE = (
    "import json, os, sys; sys.path.insert(0, os.getcwd()); import chip_smoke as cs; "
    "r = cs.web_drive(sys.argv[1], 'cpu'); "
    "print('CPU_DRIVE ' + json.dumps({k: r[k] for k in ('ledger', 'boot_s', 'flows_s')}))")
REPLACE_CONTRACT = "chip_smoke.CashV2"   # 16c: the upgrade's target contract


class _WebRig(_NodeRig):
    """Phase-11's rig with a web gateway on every node (web_port = 0,
    the finance web API mounted). Requests go from a thread while this
    thread pumps every node, as in phase 11: the gateway's handler
    threads wait on RPC futures that the pumps resolve."""

    def __init__(self, root: str, backend: str):
        super().__init__(root, backend)
        self.requests: dict = {}   # node name -> gateway requests made

    def boot(self, name: str, hub=None, **kw):
        return super().boot(name, hub, web_port=0, cordapps=WEB_CORDAPPS, **kw)

    def pump_all(self) -> None:
        for n in self.nodes:
            n.pump()

    def http(self, node, method: str, path: str, body=None) -> tuple:
        """(status, content type, body text) of one request to `node`'s
        gateway, the nodes pumped meanwhile."""
        import urllib.error
        import urllib.request

        def call():
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{node.web.port}{path}", data=data, method=method,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=WEB_TIMEOUT) as r:
                    return r.status, r.headers["Content-Type"], r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.headers["Content-Type"], e.read().decode()

        name = node.config.name
        self.requests[name] = self.requests.get(name, 0) + 1
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(call)
            self.pump_until(fut.done, f"web {method} {name}{path}", WEB_TIMEOUT)
            return fut.result()

    def json(self, node, method: str, path: str, body=None, want: int = 200):
        status, ctype, text = self.http(node, method, path, body)
        if status != want or not ctype.startswith("application/json"):
            raise RuntimeError(f"web {method} {node.config.name}{path}: {status} {ctype} "
                               f"{text[:300]!r}, expected {want} JSON")
        return json.loads(text)


def _web_balances(rig, nodes) -> dict:
    return {n.config.name: rig.json(n, "GET", "/api/cash/balances").get("USD", 0)
            for n in nodes}


def _check_planes(rig, nodes, hub, label: str) -> int:
    """Every route of WEB_PLANES answers well-formed JSON on every node:
    200, or 404 for the notary's planes on a payer; /metrics is
    Prometheus text and /profile folded stacks. Returns the requests."""
    n = 0
    for node in nodes:
        for path in WEB_PLANES:
            want = 404 if node is not hub and path in NOTARY_PLANES else 200
            rig.json(node, "GET", path, want=want)
            n += 1
        for path, kind in (("/metrics", "text/plain; version=0.0.4"), ("/profile", "text/plain")):
            status, ctype, text = rig.http(node, "GET", path)
            if status != 200 or ctype != kind or not text:
                raise RuntimeError(f"{label}: GET {node.config.name}{path} answered {status} "
                                   f"{ctype}")
            n += 1
        if "# TYPE" not in rig.http(node, "GET", "/metrics")[2]:
            raise RuntimeError(f"{label}: {node.config.name}/metrics holds no metric")
        n += 1
    return n


def _check_gateway_accounting(rig, nodes, label: str) -> dict:
    """Each node's /wire counts every request the phase made to that
    gateway before it (a request is recorded just after its answer is
    sent, so the read is repeated until the last one lands)."""
    seen = {}
    for node in nodes:
        name = node.config.name
        deadline = time.monotonic() + WEB_SETTLE
        while True:
            made = rig.requests.get(name, 0)
            eps = rig.json(node, "GET", "/wire")["gateway"]["endpoints"]
            counted = sum(e["requests"] for e in eps.values())
            if counted == made:
                break
            if counted > made or time.monotonic() > deadline:
                raise RuntimeError(f"{label}: {name}'s /wire counts {counted} gateway "
                                   f"requests, the phase made {made}")
            time.sleep(0.05)
        seen[name] = counted
    return seen


def _check_explorer(rig, nodes, ids: list, label: str) -> None:
    """Each node's /api/explorer/transactions lists exactly what it
    recorded, and every id the gateways answered is recorded."""
    recorded_any = set()
    for node in nodes:
        listed = {t["full_id"] for t in rig.json(
            node, "GET", "/api/explorer/transactions?limit=1000")["transactions"]}
        recorded = {stx.id.bytes_.hex() for stx in node.services.validated_transactions.all()}
        if listed != recorded or not recorded:
            raise RuntimeError(f"{label}: {node.config.name}'s explorer lists {len(listed)} "
                               f"transactions, it recorded {len(recorded)}")
        recorded_any |= recorded
    if not set(ids) <= recorded_any:
        raise RuntimeError(f"{label}: a transaction the gateways answered is recorded by no node")


def _check_peers(rig, hub, peers, tx_id: str, label: str) -> None:
    """What the hub's gateway pulls from its peers' gateways: the
    /cluster rollup sees every peer fresh, and GET /tx/<id> assembles
    the story of a transaction the hub notarised."""
    want = sorted(p.config.name for p in peers)
    deadline = time.monotonic() + WEB_SETTLE
    while True:
        cluster = rig.json(hub, "GET", "/cluster")
        fresh = sorted(name for name, e in cluster["nodes"].items()
                       if name != hub.config.name and not e["stale"])
        if fresh == want:
            break
        if time.monotonic() > deadline:
            raise RuntimeError(f"{label}: {hub.config.name}'s /cluster sees {fresh} of the peers "
                               f"{want} fresh")
        time.sleep(0.1)
    story = rig.json(hub, "GET", f"/tx/{tx_id.upper()}")
    if not story.get("found") or not story.get("events"):
        raise RuntimeError(f"{label}: GET /tx/<id> on {hub.config.name} holds no events: "
                           f"{str(story)[:300]}")


def web_drive(root: str, backend: str, calls=None, extras=None) -> dict:
    """Phase 16a: Hub (map host; a batching notary over distributed
    uniqueness with one member, the commit-log store and QoS), Alice
    (ed25519), Bob (p256) and Carol (secp256k1) as port nodes over TCP
    and TLS, each with its web gateway. Through the gateways only: each
    payer issues to itself (POST /api/cash/issue), WEB_PAYMENTS payments
    to Hub round robin over the payers (POST /api/cash/pay), one POST
    /api/flows/CashPaymentFlow from Bob to Carol,
    and a double spend (POST /api/flows/FinalityFlow of a spend of a
    consumed coin) answered 400 with the notary's conflict. Then every
    balance over GET /api/cash/balances against the model, every plane
    of WEB_PLANES, the gateway accounting, the explorer's transaction
    list, the Hub's /cluster rollup of its three peers and a story over
    GET /tx/<id>. `extras(rig, nodes)` runs after the checks, before the
    rig closes (16b and 16d). Raises unless every outcome is the
    expected one; returns the ledger and the figures."""
    from corda_tpu_torch.client import json_support as js
    from corda_tpu_torch.finance import CashState

    calls = calls if calls is not None else []
    rig = _WebRig(root, backend)
    try:
        t_boot = time.perf_counter()
        hub = rig.boot("Hub", notary="batching", notary_batch_wait_micros=WEB_BATCH_WAIT,
                       notary_cluster_shards=6, cluster_peers=("Hub",),
                       notary_state_store="commitlog", qos_enabled=True)
        alice = rig.boot("Alice", hub)
        bob = rig.boot("Bob", hub, scheme="secp256r1")
        carol = rig.boot("Carol", hub, scheme="secp256k1")
        payers = (alice, bob, carol)
        nodes = (hub, *payers)
        rig.discover("web (16a)")
        boot_s = time.perf_counter() - t_boot
        notary, = [p["name"] for p in rig.json(alice, "GET", "/api/notaries")]
        ledger = {"ids": [], "refused": []}
        model = {n.config.name: 0 for n in nodes}
        t0, n0 = time.perf_counter(), len(calls)
        for k, payer in enumerate(payers):
            q = 1000 + k   # distinct amounts: distinct transactions
            ledger["ids"].append(rig.json(payer, "POST", "/api/cash/issue", {
                "quantity": q, "currency": "USD", "recipient": payer.config.name,
                "notary": notary})["tx_id"])
            model[payer.config.name] += q
        t_pay, n_pay = time.perf_counter(), len(calls)
        for k in range(WEB_PAYMENTS):
            payer, payee = payers[k % 3], hub
            q = 100 + 10 * k
            ledger["ids"].append(rig.json(payer, "POST", "/api/cash/pay", {
                "quantity": q, "currency": "USD", "recipient": payee.config.name})["tx_id"])
            model[payer.config.name] -= q
            model[payee.config.name] += q
        pay_s = time.perf_counter() - t_pay
        pay_calls = len(calls) - n_pay
        carol_json = next(i["legal_identity"] for i in rig.json(bob, "GET", "/api/network")
                          if i["legal_identity"]["name"] == "Carol")
        res = rig.json(bob, "POST", "/api/flows/CashPaymentFlow",
                       {"quantity": 50, "currency": "USD", "recipient": carol_json})["result"]
        ledger["ids"].append(js.from_jsonable(res).id.bytes_.hex())
        model["Bob"] -= 50
        model["Carol"] += 50
        # the double spend: Alice's issued coin, consumed by her first payment
        coin = next(s for s in alice.vault.consumed_states(CashState)
                    if s.state.data.amount.quantity == 1000)
        stx = _spend(alice, coin, hub.services.network_map_cache.notary_identities()[0],
                     carol.party)
        err = rig.json(alice, "POST", "/api/flows/FinalityFlow",
                       {"stx": js.to_jsonable(stx)}, want=400)["error"]
        if "conflict" not in err:
            raise RuntimeError(f"web (16a): the double spend was answered {err!r}, not the "
                               f"notary's conflict")
        ledger["refused"].append(err.split(":")[0])
        flows_s = time.perf_counter() - t0
        n_calls = len(calls) - n0

        balances = _web_balances(rig, nodes)
        if balances != model:
            raise RuntimeError(f"web (16a): balances over the gateways {balances}, "
                               f"expected {model}")
        _check_explorer(rig, nodes, ledger["ids"], "web (16a)")
        t_planes = time.perf_counter()
        planes = _check_planes(rig, nodes, hub, "web (16a)")
        planes_s = time.perf_counter() - t_planes
        accounted = _check_gateway_accounting(rig, nodes, "web (16a)")
        _check_peers(rig, hub, payers, ledger["ids"][3], "web (16a)")
        out = {
            "balances": balances,
            "consumed": sorted({str(s.ref) for n in nodes
                                for s in n.vault.consumed_states(CashState)}),
            "commits": sorted((str(r), str(t)) for r, t in hub.statestore.committed.items()),
            **ledger,
        }
        if len(out["commits"]) < WEB_PAYMENTS + 1:
            raise RuntimeError(f"web (16a): the hub's notary committed {len(out['commits'])} "
                               "inputs")
        rows = [len(r) for r, _ in calls[n0:n0 + n_calls]]
        result = {"ledger": out, "boot_s": boot_s, "flows": len(ledger["ids"]) + 1,
                  "flows_s": flows_s, "pay_s": pay_s, "pay_calls": pay_calls,
                  "calls": n_calls, "rows": rows, "planes": planes, "planes_s": planes_s,
                  "accounted": accounted, "tls": rig.tls_source}
        if extras is not None:
            result.update(extras(rig, nodes))
        return result
    finally:
        rig.close()


def shell_drive(rig, nodes) -> dict:
    """Phase 16b: `connect_remote` to Bob over the TLS fabric. A wrong
    password is refused; with the right login `flow start
    CashPaymentFlow` to Hub completes, `flow watch` renders its
    progress steps and completes, `run vault_query_by` and `vault` list
    Bob's states."""
    from corda_tpu_torch.client import json_support as js
    from corda_tpu_torch.client.shell import connect_remote
    from corda_tpu_torch.finance import CashState
    from corda_tpu_torch.node.vault_query import VaultQueryCriteria

    hub, alice, bob, _ = nodes

    def login(password: str):
        shell, close = connect_remote("127.0.0.1", bob.messaging.listen_port, "Bob",
                                      bob.tls.fingerprint, "admin", password,
                                      timeout=WEB_TIMEOUT)
        pump = shell.pump
        shell.pump = lambda: (pump(), rig.pump_all())
        return shell, close

    bad, close = login("WRONG")
    try:
        out = bad.run_command("peers")
    finally:
        close()
    if not out.startswith("error"):
        raise RuntimeError(f"shell (16b): a wrong password was answered {out[:200]!r}")
    shell, close = login("pw")
    try:
        t0 = time.perf_counter()
        start = shell.run_command(
            'flow start CashPaymentFlow quantity: 20, currency: "USD", recipient: Hub')
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        watch = shell.run_command(
            'flow watch CashPaymentFlow quantity: 5, currency: "USD", recipient: Hub')
        watch_s = time.perf_counter() - t0
        query = shell.run_command(
            f"run vault_query_by {js.dumps(VaultQueryCriteria())}")
        vault = shell.run_command("vault CashState")
    finally:
        close()
    refs = [str(s.ref) for s in bob.vault.unconsumed_states(CashState)]
    if "flow completed" not in start:
        raise RuntimeError(f"shell (16b): flow start answered {start[:300]!r}")
    if "flow completed" not in watch or "✓ verifying" not in watch:
        raise RuntimeError(f"shell (16b): flow watch answered {watch[:300]!r}")
    listed = sorted(str(s.ref) for s in js.loads(query).states)
    if listed != sorted(refs):
        raise RuntimeError(f"shell (16b): run vault_query_by listed {listed}, Bob holds {refs}")
    if f"total: {len(refs)}" not in vault or not all(f"  {r}: CashState(" in vault for r in refs):
        raise RuntimeError(f"shell (16b): vault answered {vault[-300:]!r}, Bob holds {refs}")
    return {"shell": {"start_s": start_s, "watch_s": watch_s, "states": len(refs),
                      "steps": watch.count("\n✓ ") + watch.startswith("✓ ")}}


def _v2_types():
    """The upgraded Cash state and its contract (16c), defined and
    registered once."""
    global _V2
    if "_V2" not in globals():
        from corda_tpu_torch.core import serialization as ser
        from corda_tpu_torch.core.contracts import register_contract, require_that

        @ser.serializable(tag="chip_smoke.CashStateV2")
        @dataclasses.dataclass(frozen=True)
        class CashStateV2:
            amount: object
            owner: object
            version: int = 2

            @property
            def participants(self):
                return (self.owner,)

        class CashV2:
            def verify(self, ltx) -> None:
                require_that("v2 states carry version 2",
                             all(s.version == 2 for s in ltx.outputs_of_type(CashStateV2)))

        register_contract(REPLACE_CONTRACT, CashV2())
        _V2 = CashStateV2
    return _V2


def replacement_drive(verifier) -> dict:
    """Phase 16c on MockNetwork over `verifier`: NotaryOne (validating)
    and NotaryTwo, Alice (ed25519) and Bob (p256). A coin issued under
    NotaryOne is moved to NotaryTwo by NotaryChangeFlow (notarised by
    NotaryOne) and spent under NotaryTwo; a double spend of the old
    state is refused by NotaryOne ("conflict"); a second coin upgraded
    by a registered ContractUpgradeFlow, and an upgrade to a contract
    with no registered path refused. Raises unless every outcome is the
    expected one; returns the ledger."""
    from corda_tpu_torch.core.replacement import register_upgrade
    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance.cash import (
        CASH_CONTRACT, CashIssueFlow, CashMove, CashPaymentFlow, CashState)
    from corda_tpu_torch.flows.core_flows import FinalityFlow
    from corda_tpu_torch.flows.replacement import ContractUpgradeFlow, NotaryChangeFlow
    from corda_tpu_torch.testing import MockNetwork

    v2 = _v2_types()
    register_upgrade(CASH_CONTRACT, REPLACE_CONTRACT, lambda old: v2(old.amount, old.owner))
    net = MockNetwork(seed=REPLACE_SEED, batch_verifier=verifier)
    n1 = net.create_notary("NotaryOne", validating=True)
    n2 = net.create_notary("NotaryTwo")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob", scheme_id=schemes.ECDSA_SECP256R1_SHA256)
    ids, refused = [], []

    def run(label, flow, refuse=None):
        fsm = alice.start_flow(flow)
        net.run()
        try:
            stx = fsm.result_or_throw()
        except Exception as e:
            if refuse is None or refuse not in str(e):
                raise RuntimeError(f"replacement (16c) {label}: {type(e).__name__}: {e}") from e
            refused.append([label, type(e).__name__])
            return None
        if refuse is not None:
            raise RuntimeError(f"replacement (16c) {label}: was not refused")
        ids.append(str(stx.id))
        return stx

    t0 = time.perf_counter()
    ids.append(str(alice.run_flow(CashIssueFlow(1_000, "USD", alice.party, n1.party)).id))
    coin = alice.vault.unconsumed_states(CashState)[0]
    change = run("notary change", NotaryChangeFlow(coin, n2.party))
    if not any(s.by == n1.party.owning_key for s in change.sigs):
        raise RuntimeError("replacement (16c): NotaryOne did not notarise the change")
    moved = alice.vault.unconsumed_states(CashState)[0]
    if moved.state.notary != n2.party or moved.state.data != coin.state.data:
        raise RuntimeError("replacement (16c): the state did not move to NotaryTwo unchanged")
    pay = run("payment under NotaryTwo", CashPaymentFlow(400, "USD", bob.party))
    if not any(s.by == n2.party.owning_key for s in pay.sigs):
        raise RuntimeError("replacement (16c): NotaryTwo did not notarise the payment")
    b = TransactionBuilder()
    b.add_input_state(coin)
    b.add_output_state(coin.state.data.with_owner(bob.party.owning_key), CASH_CONTRACT)
    b.add_command(CashMove(), alice.party.owning_key)
    run("double spend of the old state", FinalityFlow(alice.services.sign_initial_transaction(b)),
        refuse="conflict")
    ids.append(str(alice.run_flow(CashIssueFlow(500, "USD", alice.party, n1.party)).id))
    coin = next(s for s in alice.vault.unconsumed_states(CashState)
                if s.state.data.amount.quantity == 500)
    run("unauthorised upgrade", ContractUpgradeFlow(coin, "chip_smoke.Unregistered"),
        refuse="not authorised")
    run("registered upgrade", ContractUpgradeFlow(coin, REPLACE_CONTRACT))
    upgraded = alice.vault.unconsumed_states(v2)
    if [s.state.contract for s in upgraded] != [REPLACE_CONTRACT] or any(
            s.state.data.amount.quantity == 500 for s in alice.vault.unconsumed_states(CashState)):
        raise RuntimeError("replacement (16c): the upgrade did not replace the coin")
    vaults = {n.party.name: sorted((str(s.ref), s.state.notary.name, s.state.contract)
                                   for cls in (CashState, v2)
                                   for s in n.vault.unconsumed_states(cls))
              for n in (alice, bob)}
    return {"ids": ids, "refused": refused, "vaults": vaults,
            "wall_s": time.perf_counter() - t0}


def _same_replacement(card: dict, cpu: dict) -> None:
    for key in ("ids", "refused", "vaults"):
        if card[key] != cpu[key]:
            raise RuntimeError(f"replacement (16c): the card's {key} differ from the "
                               f"CpuBatchVerifier run's")


def _register(root: str, name: str, url: str, hub) -> tuple:
    """node.toml for `name` under root (web gateway, map host Hub,
    registration_server url) and a `python -m corda_tpu_torch.node
    --config ... --initial-registration` process for it."""
    from corda_tpu_torch.node.config import NodeConfig, RpcUserConfig, write_config

    base = os.path.join(root, name)
    os.makedirs(base, exist_ok=True)
    toml = os.path.join(base, "node.toml")
    write_config(NodeConfig(
        name=name, base_dir=base, key_seed=NODE_SEED, registration_server=url, web_port=0,
        cordapps=WEB_CORDAPPS, rpc_users=(RpcUserConfig("admin", "pw", ("ALL",)),),
        network_map_peer=hub.config.name, network_map_host="127.0.0.1",
        network_map_port=hub.messaging.listen_port,
        network_map_fingerprint=hub.tls.fingerprint), toml)
    proc = subprocess.Popen([sys.executable, "-m", "corda_tpu_torch.node", "--config", toml,
                             "--initial-registration"],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return toml, proc


def doorman_drive(rig, nodes) -> dict:
    """Phase 16d: an in-process PermissioningServer (auto-approve) over
    a Doorman with its ledger under the rig's root. RegBank's node
    process registers (`--initial-registration`, exit 0,
    certificates/tls.pem stored); RegBank then boots in process from the
    same node.toml on that TLS chain, joins the map and, through its
    gateway, issues to itself and pays Alice once through the hub's
    batching notary. A second RegBank (another key) is refused with the
    doorman's "already in use"; a rule-violating name exits non-zero
    before it asks."""
    from corda_tpu_torch.node.config import load_config
    from corda_tpu_torch.node.node import Node
    from corda_tpu_torch.node.registration import Doorman, PermissioningServer
    from corda_tpu_torch.utils import x509 as xu

    hub, alice = nodes[0], nodes[1]
    root = os.path.join(rig.root, "doorman")
    server = PermissioningServer(Doorman.create(auto_approve=True,
                                                data_dir=os.path.join(root, "dm"))).start()
    try:
        t0 = time.perf_counter()
        toml, proc = _register(root, "RegBank", server.url, hub)
        out, err = proc.communicate(timeout=WEB_TIMEOUT)
        register_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"doorman (16d): --initial-registration exited "
                               f"{proc.returncode}: {err[-500:]}")
        _, dup = _register(os.path.join(root, "again"), "RegBank", server.url, hub)
        _, bad = _register(root, "evil node corp", server.url, hub)
        refusals = {}
        for label, p in (("duplicate", dup), ("bad name", bad)):
            _, perr = p.communicate(timeout=WEB_TIMEOUT)
            refusals[label] = (p.returncode, perr.strip().splitlines()[-3:])
    finally:
        server.stop()
    if refusals["duplicate"][0] == 0 or not any(
            "legal name already in use: RegBank" in line for line in refusals["duplicate"][1]):
        raise RuntimeError(f"doorman (16d): a second RegBank was answered {refusals['duplicate']}")
    if refusals["bad name"][0] == 0 or not any(
            "not allowed" in line for line in refusals["bad name"][1]):
        raise RuntimeError(f"doorman (16d): a rule-violating name was answered "
                           f"{refusals['bad name']}")
    cfg = load_config(toml)
    pem = open(os.path.join(cfg.base_dir, "certificates", "tls.pem"), "rb").read()
    chain = [xu.load_cert(b"-----BEGIN CERTIFICATE" + c)
             for c in pem.split(b"-----BEGIN CERTIFICATE")[1:]]
    if len(chain) < 3 or not xu.validate_chain(*chain[1:]):
        raise RuntimeError("doorman (16d): the stored TLS chain does not validate")
    bank = Node(dataclasses.replace(cfg, verifier_backend=rig.backend)).start()
    rig.nodes.append(bank)
    served = xu.load_cert(bank.tls.cert_pem)
    if served.serial_number != chain[0].serial_number:
        raise RuntimeError("doorman (16d): RegBank does not serve its registered TLS leaf")
    rig.discover("doorman (16d)")
    notary, = [p["name"] for p in rig.json(bank, "GET", "/api/notaries")]
    t0 = time.perf_counter()
    ids = [rig.json(bank, "POST", "/api/cash/issue", {
        "quantity": 77, "currency": "USD", "recipient": "RegBank", "notary": notary})["tx_id"]]
    ids.append(rig.json(bank, "POST", "/api/cash/pay", {
        "quantity": 7, "currency": "USD", "recipient": "Alice"})["tx_id"])
    bank_s = time.perf_counter() - t0
    got = _web_balances(rig, (bank,))["RegBank"]
    if got != 70:
        raise RuntimeError(f"doorman (16d): RegBank holds {got}, expected 70")
    return {"doorman": {"register_s": register_s, "ids": ids, "pay_s": bank_s,
                        "refusals": refusals, "chain": len(chain)}}


def phase_web(device, card: str) -> dict:
    """Phase 16 (module docstring); returns the in-process launches of
    16a-16d."""
    import tempfile

    from corda_tpu_torch.crypto import batch_verifier as bv

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "corda_tpu_torch")
    os.makedirs(scratch, exist_ok=True)
    t_phase = time.perf_counter()
    verifier = _recording_verifier(CLUSTER_BATCHES, device)

    def extras(rig, nodes):
        return {**shell_drive(rig, nodes), **doorman_drive(rig, nodes)}

    with tempfile.TemporaryDirectory(dir=scratch, prefix="web-") as tmp:
        # 16a again over verifier_backend = "cpu", in a process of its own
        # beside the card's drive: the CPU's nodes launch nothing
        cpu_proc = _cpu_drive(WEB_CPU_DRIVE, os.path.join(tmp, "web-cpu"))
        # the in-process nodes' backend "tpu" is default_verifier(): this
        # recording CudaBatchVerifier on the card
        bv.set_default_verifier(verifier)
        try:
            _zero_counters()
            web = web_drive(os.path.join(tmp, "web"), "tpu", verifier.calls, extras)
            n0 = len(verifier.calls)
            t0 = time.perf_counter()
            card_replace = replacement_drive(verifier)
            replace_calls = len(verifier.calls) - n0
            launches = _read_counters()
        finally:
            bv.set_default_verifier(None)
        cpu = _cpu_drive_result(cpu_proc, WEB_TIMEOUT, "web (16a)")
    cpu_s = cpu["flows_s"] + cpu["boot_s"]
    # the card's ledger as JSON carries it (tuples as lists)
    _same_node_ledger(json.loads(json.dumps(web["ledger"])), cpu["ledger"], "web (16a)")
    _same_replacement(card_replace, replacement_drive(bv.CpuBatchVerifier()))
    rows = web["rows"]
    print(f"web (16a): TLS from {web['tls']}; 4 nodes with gateways booted and discovered in "
          f"{web['boot_s']:.3f} s; {web['flows']} flows over REST in {web['flows_s']:.3f} s; "
          f"{WEB_PAYMENTS} POST /api/cash/pay in {web['pay_s']:.3f} s = "
          f"{WEB_PAYMENTS / web['pay_s']:.3f} REST payments/s, "
          f"{web['pay_calls'] / WEB_PAYMENTS:.2f} card calls per REST payment; "
          f"{web['calls']} card calls, rows per call {min(rows)}-{max(rows)}; the double spend "
          f"refused {web['ledger']['refused']}; balances over the gateways "
          f"{web['ledger']['balances']}; {web['planes']} plane requests answered in "
          f"{web['planes_s']:.3f} s; /wire accounts {json.dumps(web['accounted'])}; {card}")
    print(f"web (16a) over verifier_backend = \"cpu\" (boot and flows {cpu_s:.3f} s, its "
          f"own process): the same "
          f"{len(cpu['ledger']['ids'])} transaction ids, refusal, balances, "
          f"{len(cpu['ledger']['consumed'])} consumed refs and {len(cpu['ledger']['commits'])} "
          f"notary commits")
    sh = web["shell"]
    print(f"shell (16b): remote login to Bob over TLS, a wrong password refused; flow start "
          f"CashPaymentFlow {sh['start_s']:.3f} s, flow watch {sh['watch_s']:.3f} s "
          f"({sh['steps']} steps rendered done), run vault_query_by and vault list Bob's "
          f"{sh['states']} states; {card}")
    print(f"replacement (16c): ids {len(card_replace['ids'])}, refused "
          f"{card_replace['refused']}, {replace_calls} card calls, "
          f"{card_replace['wall_s']:.3f} s; the CpuBatchVerifier run's ids, refusals and "
          f"vaults equal; {card}")
    dm = web["doorman"]
    print(f"doorman (16d): --initial-registration exit 0 in {dm['register_s']:.3f} s (a "
          f"{dm['chain']}-certificate TLS chain); RegBank booted on it, issued and paid Alice "
          f"in {dm['pay_s']:.3f} s; refused: {json.dumps(dm['refusals'])}; {card}")
    for kernel in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in the web phase")
    print(f"web (ph. 16) launches: {json.dumps(launches)}; wall "
          f"{time.perf_counter() - t_phase:.3f} s; {card}")
    return {"launches": launches, "web": web, "replacement": card_replace}


# -- phase 17: the samples on the card ------------------------------------------

SAMPLES_SEED = 42            # 17a-17c: the demos' seed (their default)
IRS_FIXINGS = 3              # 17a: fixings the scheduler fires
IRS_RATES = [500, 507, 514]  # 17a: the oracle's rate for each fixing, in bp
ORACLE_SEED = 50             # 17a: the refusals' MockNetwork (the reference test's seed)
# 17c: every trade family at one trade each (the demo's default is 3 swaps and 2 of each other)
SIMM_DEPTH = dict(n_swaps=1, n_swaptions=1, n_fx_forwards=1, n_cds=1, n_equity_options=1,
                  n_commodity_forwards=1)
SIMM_WEB_SEED = 66           # 17d: the gateway's MockNetwork (tests/test_client.py's seed)
SIMM_PORTFOLIOS = 65_536     # 17d: seeded portfolios through estimate_margins_batch
SIMM_TRADES = 4              # 17d: swaps per seeded portfolio
SIMM_RTOL = 1e-4             # 17d: max relative error of the card's float32 against float64


def _calls(verifier) -> list:
    """The recording verifier's dispatches (a plain verifier records none)."""
    return getattr(verifier, "calls", [])


def irs_drive(verifier) -> dict:
    """17a: samples/irs_demo.run over `verifier`. Raises unless the
    scheduler fired every fixing at the oracle's rate and no date is left.
    Returns the ledger (every recorded transaction id, the final swap's
    encoding), the wall, the verifier's calls in the run and those of the
    fixings: the calls that verify no signature over the agreement."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.samples import irs_demo
    from corda_tpu_torch.testing import mock_network

    n0 = len(_calls(verifier))
    t0 = time.perf_counter()
    with recorded_networks(mock_network) as rec:
        final = irs_demo.run(seed=SAMPLES_SEED, n_fixings=IRS_FIXINGS, batch_verifier=verifier)
    wall = time.perf_counter() - t0
    rates = [f.rate_bps for f in final.fixings]
    if rates != IRS_RATES or final.next_fixing_date() is not None:
        raise RuntimeError(f"irs (17a): fixings {rates}, next date {final.next_fixing_date()}; "
                           f"expected {IRS_RATES} and none")
    agreed = {stx.id.bytes_ for net in rec.nets for node in net.nodes
              for stx in node.services.validated_transactions.all() if not stx.wtx.inputs}
    calls = _calls(verifier)[n0:]
    fixing_calls = sum(1 for reqs, _ in calls
                       if not any(a in r.message for r in reqs for a in agreed))
    return {"ledger": {"irs ids": rec.ids(), "irs final swap": ser.encode(final).hex()},
            "wall_s": wall, "calls": len(calls), "fixing_calls": fixing_calls}


def oracle_refusals(verifier) -> dict:
    """17a: the rate oracle's sign check, built as tests/test_samples.py's
    test_oracle_refuses_wrong_rate_and_extra_reveals builds it, on
    MockNetwork(seed=ORACLE_SEED) over `verifier`: a tear-off revealing
    only the Fix command at the table's rate is signed (the signature
    verifies over the transaction id); one at a wrong rate and one
    revealing every component are refused. Raises otherwise; returns each
    refusal's message."""
    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.samples.irs_demo import (
        IRS_CONTRACT, FixOf, InterestRateSwapState, IRSFix, RateFix, RateOracleService)
    from corda_tpu_torch.testing import MockNetwork

    net = MockNetwork(seed=ORACLE_SEED, batch_verifier=verifier)
    notary = net.create_notary("Notary")
    a, b, oracle_node = (net.create_node(n) for n in ("A", "B", "Oracle"))
    fix_of = FixOf("LIBOR-3M", 1_000)
    oracle = oracle_node.services.cordapp_service(RateOracleService)
    oracle.configure({("LIBOR-3M", 1_000): 500})
    swap = InterestRateSwapState(a.party, b.party, oracle_node.party, 1_000_000, 450,
                                 "LIBOR-3M", (1_000,))

    def build(rate_bps):
        builder = TransactionBuilder(notary.party)
        builder.add_output_state(swap.with_fixing(RateFix(fix_of, rate_bps)), IRS_CONTRACT)
        builder.add_command(IRSFix(RateFix(fix_of, rate_bps)), oracle_node.party.owning_key)
        return a.services.sign_initial_transaction(builder)

    def fix_only(c):
        return hasattr(c, "value") and isinstance(c.value, IRSFix)

    stx = build(500)
    oracle.sign(stx.wtx.build_filtered_transaction(fix_only)).verify(stx.id)
    refused = {}
    for label, ftx, word in (
            ("wrong rate", build(9_999).wtx.build_filtered_transaction(fix_only), "rate"),
            ("every component revealed", stx.wtx.build_filtered_transaction(lambda c: True),
             "command")):
        try:
            oracle.sign(ftx)
        except ValueError as e:
            if word not in str(e):
                raise RuntimeError(f"irs (17a): the oracle refused a tear-off with a {label} "
                                   f"for another reason: {e}") from e
            refused[label] = str(e)
            continue
        raise RuntimeError(f"irs (17a): the oracle signed a tear-off with a {label}")
    return refused


def simulation_drive(verifier) -> dict:
    """17b: samples/simulation.run_irs_simulation over `verifier`. Raises
    unless the trace holds FixingFlow and OracleSignHandler lines and
    flow-added and flow-removed events. Returns the ledger (the trace,
    every recorded transaction id), the wall, the events and the
    verifier's calls."""
    from corda_tpu_torch.samples.simulation import run_irs_simulation
    from corda_tpu_torch.testing import mock_network

    n0 = len(_calls(verifier))
    t0 = time.perf_counter()
    with recorded_networks(mock_network) as rec:
        sim = run_irs_simulation(seed=SAMPLES_SEED, batch_verifier=verifier)
    wall = time.perf_counter() - t0
    trace = sim.trace()
    kinds = {e.kind for e in sim.events}
    for word in ("FixingFlow", "OracleSignHandler"):
        if not any(word in line for line in trace):
            raise RuntimeError(f"simulation (17b): no {word} line in the trace")
    if not {"flow-added", "flow-removed"} <= kinds:
        raise RuntimeError(f"simulation (17b): event kinds {sorted(kinds)}")
    return {"ledger": {"simulation trace": trace, "simulation ids": rec.ids()},
            "wall_s": wall, "events": len(sim.events), "calls": len(_calls(verifier)) - n0}


def simm_drive(verifier) -> dict:
    """17c: samples/simm_demo.run over `verifier` at SIMM_DEPTH (every
    trade family, every risk class, psi aggregation). Raises unless the
    recorded valuation holds every trade and a positive margin, and
    simm.simm_im on the host, from the ladders of each party's recorded
    book, gives that margin again. Returns the ledger (every recorded
    transaction id, the valuation's encoding), the wall, the margin's
    breakdown and the verifier's calls."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.samples import simm, simm_demo
    from corda_tpu_torch.testing import mock_network

    n0 = len(_calls(verifier))
    t0 = time.perf_counter()
    with recorded_networks(mock_network) as rec:
        v = simm_demo.run(seed=SAMPLES_SEED, batch_verifier=verifier, **SIMM_DEPTH)
    wall = time.perf_counter() - t0
    trades = sum(SIMM_DEPTH.values())
    if v.portfolio_size != trades or v.margin <= 0:
        raise RuntimeError(f"simm (17c): {v.portfolio_size} trades valued at {v.margin}; "
                           f"expected {trades} at a positive margin")
    nodes = {node.name: node for net in rec.nets for node in net.nodes}
    for name in ("PartyA", "PartyB"):
        book = {family: [s.state.data for s in nodes[name].vault.unconsumed_states(cls)]
                for family, cls in simm_demo.TRADE_FAMILIES.items()}
        s = simm_demo.portfolio_ladders_book(book, v.valuation_micros)
        classes = dict(equity=s.equity, commodity=s.commodity, credit_q=s.credit_q,
                       equity_vega=s.equity_vega, equity_cvr=s.equity_cvr)
        im = simm.simm_im(s.delta, s.vega, s.fx, **classes)
        if im != v.margin:
            raise RuntimeError(f"simm (17c): simm_im over {name}'s book is {im}, the recorded "
                               f"margin {v.margin}")
    parts = simm.simm_breakdown(s.delta, s.vega, s.fx, **classes)
    return {"ledger": {"simm ids": rec.ids(), "simm valuation": ser.encode(v).hex()},
            "wall_s": wall, "margin": v.margin, "trades": trades,
            "parts": {k: round(float(x), 2) for k, x in parts.items()},
            "calls": len(_calls(verifier)) - n0}


def simm_web_drive(verifier) -> dict:
    """17d: the /api/simm API as tests/test_client.py's `web` fixture and
    test_simm_web_api build it, on MockNetwork(seed=SIMM_WEB_SEED) over
    `verifier`: Notary, Alice (an RPC server, and an in-process
    NodeWebServer over an RPC client of it) and Bob; one swaption agreed
    by DealInstigatorFlow, then GET portfolio/margin, the calculate POST
    with Bob and GET portfolio/valuations. Raises unless each answers
    200, the POST's margin is the GET's and one valuation of one trade is
    recorded at it. Returns the ledger (the three answers' JSON, every
    recorded transaction id), the wall and the verifier's calls."""
    import urllib.request

    import corda_tpu_torch.samples.simm_web  # noqa: F401 - registers /api/simm
    from corda_tpu_torch.client.webserver import NodeWebServer
    from corda_tpu_torch.finance.trade_flows import DealInstigatorFlow
    from corda_tpu_torch.node import rpc as rpclib
    from corda_tpu_torch.samples.simm_demo import SWAPTION_CONTRACT, SwaptionState
    from corda_tpu_torch.testing import mock_network

    n0 = len(_calls(verifier))
    t0 = time.perf_counter()
    with recorded_networks(mock_network) as rec:
        net = mock_network.MockNetwork(seed=SIMM_WEB_SEED, batch_verifier=verifier)
    notary = net.create_notary("Notary")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob")
    users = rpclib.RPCUserService(rpclib.RpcUser("sh", "pw", ("ALL",)))
    rpclib.RPCServer(rpclib.CordaRPCOpsImpl(alice.services, alice.smm), alice.messaging, users)
    client = rpclib.RPCClient(net.fabric.endpoint("web-console"), "Alice", "sh", "pw")
    server = NodeWebServer(client, pump=lambda: net.run(), rpc_timeout=WEB_TIMEOUT).start()
    answers = {}
    try:
        swaption = SwaptionState(buyer=alice.party, seller=bob.party, notional=5_000_000,
                                 strike_bps=350, expiry_micros=2 * 31_557_600 * 10**6,
                                 tenor_years=5, index_name="LIBOR-3M")
        fsm = alice.start_flow(DealInstigatorFlow(bob.party, swaption, SWAPTION_CONTRACT,
                                                  notary.party))
        net.run()
        fsm.result_or_throw()
        for method, path, body in (
                ("GET", "portfolio/margin", None),
                ("POST", "portfolio/valuations/calculate", {"counterparty": "Bob"}),
                ("GET", "portfolio/valuations", None)):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/api/simm/{path}", method=method,
                data=None if body is None else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=WEB_TIMEOUT) as r:
                answers[f"{method} {path}"] = (r.status, json.loads(r.read()))
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    (s1, margin), (s2, post), (s3, vals) = answers.values()
    recorded = vals.get("valuations", [])
    if (s1, s2, s3) != (200, 200, 200) or post.get("margin") != margin.get("margin") or [
            (v["margin"], v["portfolio_size"]) for v in recorded] != [(margin["margin"], 1)]:
        raise RuntimeError(f"simm web (17d): answers {json.dumps(answers)}")
    return {"ledger": {"simm web answers": answers, "simm web ids": rec.ids()},
            "wall_s": wall, "margin": margin["margin"], "calls": len(_calls(verifier)) - n0}


def samples_drive(verifier) -> dict:
    """17a-17d's demos over `verifier`: {part: its result}, with every
    part's ledger merged under "ledger"."""
    out = {"irs": irs_drive(verifier), "oracle": oracle_refusals(verifier),
           "simulation": simulation_drive(verifier), "simm": simm_drive(verifier),
           "simm web": simm_web_drive(verifier)}
    out["ledger"] = {k: v for part in out.values() for k, v in part.get("ledger", {}).items()}
    return out


def seeded_ladders(n: int, seed: int):
    """[n, K] float64 IR delta ladders, each of SIMM_TRADES seeded swaps
    (notionals 1e6-1e8, each paid or received, maturities across the SIMM
    vertices, each swap's PV01 split between its framing vertices as
    simm.bucket_pv01 splits it)."""
    import numpy as np

    from corda_tpu_torch.samples import simm

    rng = np.random.default_rng(seed)
    tenors = np.asarray(simm.TENORS_Y)
    notional = rng.uniform(1e6, 1e8, size=(n, SIMM_TRADES))
    sign = rng.choice([-1.0, 1.0], size=(n, SIMM_TRADES))
    t = rng.uniform(tenors[0], tenors[-1], size=(n, SIMM_TRADES))
    hi = np.clip(np.searchsorted(tenors, t), 1, len(tenors) - 1)
    frac = (t - tenors[hi - 1]) / (tenors[hi] - tenors[hi - 1])
    pv01 = sign * notional * t / 10_000.0
    rows = np.repeat(np.arange(n), SIMM_TRADES)
    out = np.zeros((n, len(tenors)))
    np.add.at(out, (rows, (hi - 1).ravel()), (pv01 * (1.0 - frac)).ravel())
    np.add.at(out, (rows, hi.ravel()), (pv01 * frac).ravel())
    return out


def margins_batch_drive(device) -> dict:
    """17d: samples/simm.estimate_margins_batch on `device` over
    SIMM_PORTFOLIOS seeded portfolios, held against float64
    bucket_margins on the host. Raises unless the estimates are finite
    float32 of shape [P] within SIMM_RTOL of it. Returns the max and
    median relative error and the seconds of each path."""
    import numpy as np

    from corda_tpu_torch.samples import simm

    lad = seeded_ladders(SIMM_PORTFOLIOS, SAMPLES_SEED)
    simm.estimate_margins_batch(lad[:256], device=device)    # warm-up
    t0 = time.perf_counter()
    est = simm.estimate_margins_batch(lad, device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k, _ = simm.bucket_margins(lad)
    host_s = time.perf_counter() - t0
    if est.shape != (SIMM_PORTFOLIOS,) or est.dtype != np.float32 or not np.isfinite(est).all():
        raise RuntimeError(f"simm analytics (17d): estimates of shape {est.shape}, {est.dtype}, "
                           f"finite {bool(np.isfinite(est).all())}")
    rel = np.abs(est.astype(np.float64) - k) / k
    if rel.max() > SIMM_RTOL:
        raise RuntimeError(f"simm analytics (17d): max relative error {rel.max():.3e} > "
                           f"{SIMM_RTOL}")
    return {"max_rel": float(rel.max()), "median_rel": float(np.median(rel)),
            "card_s": card_s, "host_s": host_s}


def phase_samples(device, card: str) -> dict:
    """Phase 17 (module docstring); returns the launches of 17a-17d."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    t_phase = time.perf_counter()
    verifier = _recording_verifier(CLUSTER_BATCHES, device)
    _zero_counters()
    got = samples_drive(verifier)
    launches = _read_counters()
    cpu = samples_drive(CpuBatchVerifier())
    for key, value in got["ledger"].items():
        if value != cpu["ledger"][key]:
            raise RuntimeError(f"samples (17): the card's {key} differ from the "
                               f"CpuBatchVerifier run's")
    irs, sim, sm, web = got["irs"], got["simulation"], got["simm"], got["simm web"]
    print(f"irs (17a): fixings {IRS_RATES} bp by the scheduler in {irs['wall_s']:.3f} s "
          f"(CpuBatchVerifier {cpu['irs']['wall_s']:.3f} s), {irs['calls']} card calls, "
          f"{irs['fixing_calls'] / IRS_FIXINGS:.2f} per fixing; "
          f"{len(irs['ledger']['irs ids'])} transaction ids and the final swap equal to "
          f"CpuBatchVerifier's; the oracle refused {json.dumps(got['oracle'])}; {card}")
    print(f"simulation (17b): {sim['events']} events, {len(sim['ledger']['simulation trace'])} "
          f"trace lines equal to CpuBatchVerifier's in {sim['wall_s']:.3f} s "
          f"({cpu['simulation']['wall_s']:.3f} s), {sim['calls']} card calls; {card}")
    print(f"simm (17c): {sm['trades']} trades (one per family) agreed and valued at margin "
          f"{sm['margin']} in {sm['wall_s']:.3f} s ({cpu['simm']['wall_s']:.3f} s), "
          f"{sm['calls']} card calls, {sm['calls'] / (sm['trades'] + 1):.2f} per recorded "
          f"agreement; simm_im on the host over both books equal; breakdown "
          f"{json.dumps(sm['parts'])}; the valuation equal to CpuBatchVerifier's to the bit; "
          f"{card}")
    print(f"simm web (17d): a swaption, GET margin, the calculate POST and GET valuations "
          f"in {web['wall_s']:.3f} s ({cpu['simm web']['wall_s']:.3f} s), {web['calls']} card "
          f"calls, margin {web['margin']}; the answers equal to CpuBatchVerifier's; {card}")
    m = margins_batch_drive(device)
    print(f"simm analytics (17d): estimate_margins_batch of {SIMM_PORTFOLIOS} seeded "
          f"{SIMM_TRADES}-swap portfolios (P x K = {SIMM_PORTFOLIOS} x 12) on the card in "
          f"{m['card_s']:.4f} s, float64 bucket_margins on the host in {m['host_s']:.4f} s; "
          f"relative error max {m['max_rel']:.3e} (held to {SIMM_RTOL}), median "
          f"{m['median_rel']:.3e}; {card}")
    if launches["ed_ladder"] == 0:
        raise RuntimeError("ed_ladder was not launched in the samples phase")
    print(f"samples (ph. 17) launches: {json.dumps(launches)}; wall "
          f"{time.perf_counter() - t_phase:.3f} s; {card}")
    return {"launches": launches, "samples": got, "margins": m}


# -- phase 18: the test kits and the tools ------------------------------------

FLEET_SEED = 11              # 18a: tests/test_fleet.py's batching fixture (198-224)
FLEET_CLIENTS = 1024         # 18a: client identities
FLEET_KEY_POOL = 8           # 18a: signing keys the identities share (FleetScenario's default)
FLEET_CAP = 8                # 18a: the QoS policy's batch, spends per flush
FLEET_ROUND = 20_000         # 18a-18b: simulated µs per delivery round
FLEET_BATCHES = (128, 4096)  # 18a-18b: the recording verifier's buckets
ARC_SEED = 13                # 18b: test_exact_accounting_replaces_loss_allowance_with_wal
ARC_WORKERS = 2              # 18b: the verifier pool's workers
EXPLORER_SEED = 5            # 18c: ExplorerSimulation's seed (tests/test_tools.py)
EXPLORER_STEPS = 6           # 18c: simulation steps against Alice
BENCH_NODES = ({"name": "Hub", "notary": "validating"}, {"name": "Alice"}, {"name": "Bob"})
BENCH_TIMEOUT = 180.0        # s any one 18c launch or flow may take before the phase fails
FLEET_CPU_DRIVE = (
    "import json, os, sys; sys.path.insert(0, os.getcwd()); import chip_smoke as cs; "
    "from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier; "
    "r = cs.fleet_soak(CpuBatchVerifier()); "
    "print('CPU_DRIVE ' + json.dumps({'records': r['records']}))")


def _fleet_policy(cap: int):
    from corda_tpu_torch.node import qos

    return qos.QosPolicy(target_p99_micros=5 * FLEET_ROUND, min_batch=cap, max_batch=cap,
                         max_wait_micros=0, brownout_after_flushes=3)


def _fleet_records(rep) -> list:
    return [[r.rid, r.client, str(r.tx_id), r.kind, r.phase, r.outcome, r.shed_reason,
             r.submitted_at, r.answered_at] for r in rep.records]


def fleet_soak(verifier) -> dict:
    """18a: the reference's batching soak (tests/test_fleet.py:198-224) over
    `verifier`, reconciled as test_batching_soak_reconciles_with_slo_and_
    brownout and its health-story twin reconcile it. Raises on any
    failed check. Returns the records (JSON), the outcomes, the verdict
    and the wall."""
    from corda_tpu_torch.node import qos as qoslib
    from corda_tpu_torch.testing import fleet as fl

    R, cap = FLEET_ROUND, FLEET_CAP
    mix = fl.TrafficMix(deadline_micros=6 * R, conflict_fraction=0.06)
    scenario = fl.FleetScenario(
        clients=FLEET_CLIENTS,
        phases=(fl.Phase("ramp", 3, cap // 2, mix), fl.Phase("steady", 14, cap, mix),
                fl.Phase("spike", 8, 3 * cap, fl.TrafficMix(
                    deadline_micros=6 * R, bulk_fraction=0.34, conflict_fraction=0.06)),
                fl.Phase("steady2", 8, cap - 2, mix)),
        round_micros=R, drain_rounds=60, seed=FLEET_SEED)
    if scenario.key_pool != FLEET_KEY_POOL:
        raise RuntimeError(f"fleet (18a): key pool {scenario.key_pool}, the reference's is "
                           f"{FLEET_KEY_POOL}")
    t0 = time.perf_counter()
    sim = fl.FleetSim(scenario, "batching", chaos=(fl.freeze(0, at=0.12, until=0.22),),
                      qos_policy=_fleet_policy(cap), batch_verifier=verifier)
    rep = sim.run()
    wall = time.perf_counter() - t0
    checker = fl.InvariantChecker(rep)
    verdict = checker.check_all(slo_p99_micros=5 * R, expect_conflicts=True,
                                expect_brownout=True)
    checker.check_health_story()
    out = rep.outcomes()
    shed = rep.qos.snapshot()["shed"]
    if not (verdict["reconciled"] is True and rep.distinct_clients >= 300
            and out.get(fl.OUT_SIGNED, 0) > 0 and out.get(fl.OUT_SHED, 0) > 0
            and 0 < rep.bulk_shed_brownout == shed.get(qoslib.SHED_BROWNOUT_BULK, 0)
            and shed.get(qoslib.SHED_EXPIRED_FLUSH, 0) >= out.get(fl.OUT_SHED, 0)
            and sum(1 for e in rep.chaos_log if e["kind"] == "freeze") == 1):
        raise RuntimeError(f"fleet (18a): outcomes {out}, {rep.distinct_clients} clients, "
                           f"bulk shed {rep.bulk_shed_brownout}, QoS shed {shed}")
    return {"records": _fleet_records(rep), "outcomes": out, "verdict": verdict,
            "wall_s": wall, "clients": rep.distinct_clients, "bulk": (rep.bulk_offered,
                                                                      rep.bulk_shed_brownout)}


def fault_arc(verifier) -> dict:
    """18b: test_exact_accounting_replaces_loss_allowance_with_wal's soak
    with a verifier pool of ARC_WORKERS over `verifier` and worker 0
    killed mid-stream; then a device_fault soak over the card refused.
    Raises on any failed check."""
    from corda_tpu_torch.testing import fleet as fl

    R = FLEET_ROUND
    scenario = fl.FleetScenario(
        clients=16, phases=(fl.Phase("steady", 6, 4, fl.TrafficMix(
            deadline_micros=20 * R, conflict_fraction=0.2)),),
        round_micros=R, seed=ARC_SEED)
    t0 = time.perf_counter()
    sim = fl.FleetSim(scenario, "batching", qos_policy=_fleet_policy(8), intent_wal=True,
                      verifier_pool=ARC_WORKERS, chaos=(fl.kill_verifier(0, at=0.3),),
                      batch_verifier=verifier)
    workers = [w._verifier for w in sim._verify_workers]
    if len(workers) != ARC_WORKERS or any(w is not verifier for w in workers):
        raise RuntimeError("fault arc (18b): the pool's workers do not verify on the fleet's "
                           "verifier (D10)")
    rep = sim.run()
    wall = time.perf_counter() - t0
    checker = fl.InvariantChecker(rep)
    checker.check_all(expect_conflicts=True)
    checker.check_exact_accounting()
    if not (rep.intent_wal and rep.intent_unresolved == 0 and rep.verify_workers_lost == 1
            and rep.verify_offered > 0 and rep.verify_resolved == rep.verify_offered
            and rep.verify_failed == 0):
        raise RuntimeError(f"fault arc (18b): unresolved intents {rep.intent_unresolved}, "
                           f"pool {rep.verify_resolved}/{rep.verify_offered} resolved, "
                           f"{rep.verify_failed} failed, {rep.verify_workers_lost} lost")
    refused = []
    for label, v in (("default", None), ("recording", verifier)):
        try:
            fl.FleetSim(scenario, "batching", chaos=(fl.device_fault(at=0.2, heal_at=0.6),),
                        batch_verifier=v)
        except ValueError as e:
            if "D2" not in str(e):
                raise
            refused.append(label)
        else:
            raise RuntimeError(f"fault arc (18b): a device_fault soak over the {label} card "
                               "verifier was not refused (D10)")
    return {"outcomes": rep.outcomes(), "wall_s": wall, "refused": refused,
            "pool": (rep.verify_offered, rep.verify_resolved, rep.verify_redispatched),
            "replayed": rep.intent_replayed}


def _free_base(n: int) -> int:
    """A port p with p .. p + n - 1 free now (DemoBench numbers its nodes'
    ports from a base)."""
    import socket

    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        held = []
        try:
            for k in range(n):
                held.append(socket.socket())
                held[-1].bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for h in held:
                h.close()
    raise RuntimeError("no free port range")


def _bench_call(port: int, path: str, body=None) -> tuple:
    """(status, JSON) of one request to the launcher's API."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST" if body is not None else "GET",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _bench_up(port: int, name: str) -> dict:
    deadline = time.monotonic() + BENCH_TIMEOUT
    while time.monotonic() < deadline:
        _, st = _bench_call(port, "/api/bench/status")
        node = next((n for n in st["nodes"] if n["name"] == name), {})
        state = node.get("state") or ""
        if state == "up":
            return node
        if state.startswith("failed"):
            raise RuntimeError(f"demobench (18c): {name} failed to start: {state}")
        time.sleep(0.2)
    raise RuntimeError(f"demobench (18c): {name} not up within {BENCH_TIMEOUT:.0f} s")


def _step_expectation(line: str):
    """The transaction one ExplorerSimulation step leaves in the
    initiator's feed: an issue of the logged amount, or a payment that
    spends inputs and pays the logged amount."""
    from corda_tpu_torch.core.transactions import SignedTransaction
    from corda_tpu_torch.testing.expect import expect

    kind = line.split()[0]
    if kind not in ("issue", "pay"):
        raise RuntimeError(f"demobench (18c): the simulation idled: {line!r}")
    amount = int(line.split()[1])

    def amounts(stx):
        return [getattr(o.data, "amount", None) and o.data.amount.quantity
                for o in stx.wtx.outputs]

    if kind == "issue":
        return expect(SignedTransaction, lambda stx: not stx.wtx.inputs
                      and amounts(stx) == [amount])
    return expect(SignedTransaction, lambda stx: len(stx.wtx.inputs) > 0
                  and amount in amounts(stx))


def demobench_drive(root: str, backend: str = "tpu", check_contexts: bool = True) -> dict:
    """18c: web_demobench on port 0, Hub (map host, validating notary),
    Alice and Bob launched through its API as node processes on
    `backend`; ExplorerSimulation against Alice over RPC, its flows
    awaited, a NodeMonitorModel's transaction feed held to an expect
    sequence built from the step log; balances against a vault query;
    the explorer and the graph rendered; CUDA contexts counted; SIGTERM
    exits 0. Raises on any failed check."""
    from corda_tpu_torch.node.vault_query import VaultQueryCriteria
    from corda_tpu_torch.testing.expect import expect_events, record, sequence
    from corda_tpu_torch.tools.explorer import Explorer, ExplorerSimulation
    from corda_tpu_torch.tools.graphs import transactions_to_dot
    from corda_tpu_torch.tools.models import NodeMonitorModel, PumpedOps
    from corda_tpu_torch.tools.web_demobench import serve

    ctx0 = _cuda_contexts() if check_contexts else 0
    server, launcher = serve(os.path.join(root, "bench"), port=0,
                             base_port=_free_base(len(BENCH_NODES)))
    port, procs, model = server.server_port, {}, None
    t0 = time.perf_counter()
    try:
        for node in BENCH_NODES:
            body = dict(node, **({} if backend == "tpu" else {"verifier_backend": backend}))
            status, answer = _bench_call(port, "/api/bench/add", body)
            if status != 202:
                raise RuntimeError(f"demobench (18c): adding {node['name']}: {status} {answer}")
            up = _bench_up(port, node["name"])
            if up["map_host"] is not (node["name"] == "Hub"):
                raise RuntimeError(f"demobench (18c): {node['name']}'s map host flag {up}")
        boot_s = time.perf_counter() - t0
        bench = launcher.bench
        procs = {name: n.process for name, n in bench.nodes.items()}
        ops = PumpedOps(bench.rpc("Alice"), bench.pump, timeout=BENCH_TIMEOUT)
        deadline = time.monotonic() + BENCH_TIMEOUT
        while len(ops.network_map_snapshot()) < len(BENCH_NODES):
            if time.monotonic() > deadline:
                raise RuntimeError("demobench (18c): Alice's map never listed every node")
            time.sleep(0.2)
        model = NodeMonitorModel(ops)
        sim = ExplorerSimulation(ops, currencies=("USD",), seed=EXPLORER_SEED)
        log = []

        def steps():
            for _ in range(EXPLORER_STEPS):
                log.append(sim.step())
                bench.wait(sim.handles[-1].result, BENCH_TIMEOUT)   # raises if the flow failed
            ops.current_node_time()     # a round trip drains the feeds' last updates

        t1 = time.perf_counter()
        events = record(model.transactions.changes, steps)
        flows_s = time.perf_counter() - t1
        sim.close()
        expect_events(events, sequence(*(_step_expectation(line) for line in log)))
        page = ops.vault_query_by(VaultQueryCriteria())
        queried: dict = {}
        for sar in page.states:
            amount = sar.state.data.amount
            product = str(getattr(amount.token, "product", amount.token))
            queried[product] = queried.get(product, 0) + amount.quantity
        if model.vault.balances() != queried:
            raise RuntimeError(f"demobench (18c): the model's balances "
                               f"{model.vault.balances()} differ from the vault query's "
                               f"{queried}")
        explorer = Explorer(ops)
        try:
            panes = explorer.render()
        finally:
            explorer.close()
        stxs = ops.verified_transactions_snapshot()
        dot = transactions_to_dot(stxs)
        if not ("Alice — ledger explorer" in panes and f"transactions: {len(stxs)}" in panes
                and dot.startswith("digraph") and len(stxs) == len(events) == len(log)):
            raise RuntimeError(f"demobench (18c): {len(stxs)} transactions, {len(events)} feed "
                               f"events for {len(log)} steps; explorer:\n{panes}")
        apps = _smi_apps() if check_contexts else ""
        contexts = _cuda_contexts() if check_contexts else None
        if check_contexts and contexts - ctx0 < len(procs):
            raise RuntimeError(f"demobench (18c): {contexts - ctx0} new CUDA contexts for "
                               f"{len(procs)} node processes (nvidia-smi compute apps: "
                               f"{apps.strip()!r})")
        model.close()
        model = None
        t2 = time.perf_counter()
        server.shutdown()
        launcher.shutdown()
        stop_s = time.perf_counter() - t2
        codes = {name: p.returncode for name, p in procs.items()}
        if codes != {name: 0 for name in procs}:
            raise RuntimeError(f"demobench (18c): exit codes after SIGTERM {codes}")
        return {"log": log, "balances": queried, "boot_s": boot_s, "flows_s": flows_s,
                "stop_s": stop_s, "transactions": len(stxs), "edges": dot.count("->"),
                "contexts": (ctx0, contexts), "apps": apps.strip(),
                "wall_s": time.perf_counter() - t0}
    finally:
        if model is not None:
            model.close()
        server.shutdown()
        launcher.shutdown()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_tools(device, card: str) -> dict:
    """Phase 18 (module docstring); returns the launches of 18a-18b."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        cpu_proc = _cpu_drive(FLEET_CPU_DRIVE, tmp)
        verifier = _recording_verifier(FLEET_BATCHES, device)
        _zero_counters()
        soak = fleet_soak(verifier)
        soak_calls = list(_calls(verifier))
        arc = fault_arc(verifier)
        launches = _read_counters()
        cpu = _cpu_drive_result(cpu_proc, BENCH_TIMEOUT, "fleet (18a)")
        if soak["records"] != cpu["records"]:
            diff = next(k for k, (a, b) in enumerate(zip(soak["records"], cpu["records"]))
                        if a != b) if len(soak["records"]) == len(cpu["records"]) else None
            raise RuntimeError(f"fleet (18a): the card's records differ from the "
                               f"CpuBatchVerifier soak's (first at {diff}: "
                               f"{soak['records'][diff] if diff is not None else 'lengths'} vs "
                               f"{cpu['records'][diff] if diff is not None else ''})")
        rows = [len(reqs) for reqs, _ in soak_calls] or [0]
        print(f"fleet (18a): {FLEET_CLIENTS} clients ({soak['clients']} reached), outcomes "
              f"{json.dumps(soak['outcomes'])}, bulk offered/browned out "
              f"{soak['bulk'][0]}/{soak['bulk'][1]}, reconciled with the SLO, the brownout "
              f"and the health story in {soak['wall_s']:.3f} s; {len(soak_calls)} card calls, "
              f"rows per call {min(rows)}-{max(rows)} (mean {sum(rows) / len(rows):.2f}); "
              f"{len(soak['records'])} records equal to the CpuBatchVerifier soak's (its own "
              f"process); {card}")
        print(f"fault arc (18b): outcomes {json.dumps(arc['outcomes'])}, pool requests "
              f"offered/resolved/redispatched {'/'.join(map(str, arc['pool']))} on the card "
              f"(D10), worker 0 lost, {arc['replayed']} intents replayed, none unresolved, "
              f"exact accounting in {arc['wall_s']:.3f} s; device_fault over the card refused "
              f"(D2) for the {' and '.join(arc['refused'])} verifier; {card}")
        with card_processes(exclusive=True):
            bench = demobench_drive(tmp)
    print(f"demobench (18c): Hub, Alice and Bob up through /api/bench/add in "
          f"{bench['boot_s']:.3f} s; {EXPLORER_STEPS} simulation steps {json.dumps(bench['log'])} "
          f"in {bench['flows_s']:.3f} s, the feed matching their expect sequence; balances "
          f"{json.dumps(bench['balances'])} equal to a vault query; the explorer and a graph "
          f"of {bench['transactions']} transactions, {bench['edges']} edges; CUDA contexts "
          f"{bench['contexts'][0]} before the nodes, {bench['contexts'][1]} while they ran "
          f"(nvidia-smi: {bench['apps']!r}); SIGTERM exits 0 in {bench['stop_s']:.3f} s; "
          f"{card}")
    if launches["wei_ladder_windowed"] == 0:
        raise RuntimeError("wei_ladder_windowed was not launched in the tools phase")
    print(f"tools (ph. 18) launches: {json.dumps(launches)}; wall "
          f"{time.perf_counter() - t_phase:.3f} s; {card}")
    return {"launches": launches, "soak": soak, "arc": arc, "bench": bench}


SHARDS_MESH_ROWS = 4096      # 19a: phase 5's corpus, mixed, over the mesh on the one card
SHARDS_MESH_SLICES = 4       # 19a: the mesh's entries, each the one card
SHARDS_SPENDS = 4096         # 19b: the phase-6 fixture's first spends
SHARDS_SHARDS = 4            # 19b: the notary's shards, one per-shard verifier each
SHARDS_SAMPLE = 64           # 19b: rows of the card's verdicts held against CpuBatchVerifier


def _recorded(verifier):
    """`verifier` keeping each dispatch's requests and handle in `.calls`."""
    calls, inner = [], verifier.verify_batch_async

    def verify_batch_async(requests):
        pv = inner(requests)
        calls.append((list(requests), pv))
        return pv

    verifier.verify_batch_async = verify_batch_async
    verifier.calls = calls
    return verifier


def phase_shards(device, card: str) -> dict:
    """Phase 19 (module docstring); returns the launches of 19a-19b."""
    from corda_tpu_torch.crypto import aot_store, schemes
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier, per_shard_verifiers
    from corda_tpu_torch.parallel import dryrun
    from corda_tpu_torch.parallel import mesh as meshlib
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    t_phase = time.perf_counter()
    tiled = spi_corpus()
    fx = build_fixture(SHARDS_SPENDS, **NOTARY_FIXTURE)
    mesh = meshlib.make_mesh([device] * SHARDS_MESH_SLICES)
    mixed = (schemes.EDDSA_ED25519_SHA512, schemes.ECDSA_SECP256K1_SHA256,
             schemes.ECDSA_SECP256R1_SHA256)
    reqs, expect = tiled(mixed, SHARDS_MESH_ROWS)
    verifiers = [_recorded(v) for v in per_shard_verifiers(SHARDS_SHARDS, devices=[device])]
    _zero_counters()
    t = time.perf_counter()
    _flush(CudaBatchVerifier(batch_sizes=(128, 1024, 4096), mesh=mesh), reqs, expect,
           f"mesh over {[str(d) for d in mesh.device_list()]} (19a)")
    mesh_s = time.perf_counter() - t
    mesh_launches = _read_counters()
    out = dryrun.notary_pass(fx, verifiers, SHARDS_SHARDS)
    launches = _read_counters()
    calls = [c for v in verifiers for c in v.calls]
    disp = _check_notary(fx, out["service"], out["answers"], calls,
                         "per-shard notary (19b)", SHARDS_SAMPLE)
    idle = [k for k, v in enumerate(verifiers) if not v.calls]
    if idle:
        raise RuntimeError(f"per-shard notary (19b): the verifiers of shards {idle} never "
                           "dispatched")
    print(f"mesh (19a): {SHARDS_MESH_ROWS} mixed rows over {mesh} in {mesh_s:.3f} s, every row "
          f"the CPU reference's; launches {json.dumps(mesh_launches)}; {card}")
    print(f"per-shard notary (19b): {SHARDS_SPENDS} spends over {SHARDS_SHARDS} shards, "
          f"per_shard_verifiers(devices=[{device}]) ({'/'.join(str(v.device) for v in verifiers)}), "
          f"in {out['wall_s']:.3f} s = {SHARDS_SPENDS / out['wall_s']:.1f} notarisations/s; "
          f"{len(calls)} card calls ({'/'.join(str(len(v.calls)) for v in verifiers)} by shard), "
          f"{disp['rows']} rows, device (chunk events, summed) {disp['device_s']:.3f} s; every "
          f"answer its label; {card}")
    try:
        CudaBatchVerifier(mesh=mesh, device=device)
    except ValueError as e:
        print(f"refusal (19c): CudaBatchVerifier(mesh=..., device=...) raised ValueError: {e}")
    else:
        raise RuntimeError("refusal (19c): CudaBatchVerifier took mesh= with device=")
    t = time.perf_counter()
    warm = aot_store.prewarm(CHUNK, device=device)
    built = [stem for stem, how in warm["libraries"].items() if how != "reused"]
    if built:
        raise RuntimeError(f"prewarm (19d) rebuilt {built} instead of reusing phase 2's build")
    print(f"prewarm (19d): {json.dumps(warm['libraries'])} from {warm['store']}, verify "
          f"seconds {json.dumps({k: round(v, 3) for k, v in warm['seconds'].items()})}, "
          f"{time.perf_counter() - t:.3f} s; {card}")
    for kernel in ("ed_ladder", "wei_ladder", "wei_ladder_windowed"):
        if mesh_launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched over the mesh (19a)")
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches[kernel] == mesh_launches[kernel]:
            raise RuntimeError(f"{kernel} was not launched by the per-shard notary (19b)")
    print(f"shards (ph. 19) launches: {json.dumps(launches)}; wall "
          f"{time.perf_counter() - t_phase:.3f} s; {card}")
    return {"launches": launches, "notary": out, "prewarm": warm}


# Where each phase runs. The card is idle most of a phase's wall (its
# time goes to torch-op launches on the host, node processes and
# timeouts: PERF.md section 5), so after QUIET, which runs alone (the
# kernel table's times, the host's torch-op rate), the phases run in
# five processes at once on the one card: this one (HOME) and four
# lanes, each this script with `--lane`.
QUIET = ("3 timing", "4")
HOME = ("3 parity", "5", "6", "8", "14")
LANES = (("11", "13", "15", "7"), ("16", "10"), ("12", "17", "9"), ("18", "19"))
LANE_TIMEOUT = 1100.0        # s a lane may take before the run fails
COLUMNS = ("clusters_launches", "nodes_launches", "drives_launches", "telemetry_launches",
           "planes_launches", "xshard_launches", "web_launches", "samples_launches",
           "fleet_launches", "shards_launches")


def run_phases(ids, device, card: str, report: dict) -> tuple:
    """The phases `ids` in this process, in order: ({phase: wall s},
    {kernel-table column: launches by kernel}). Without phase 6 the
    process builds the fixture when a phase first needs it."""
    fx = None

    def fixture():
        nonlocal fx
        if fx is None:
            fx = notary_fixture()
        return fx

    walls, columns = {}, {}
    for pid in ids:
        t = time.perf_counter()
        if pid == "3 parity":
            phase_parity(device, report)
        elif pid == "3 timing":
            phase_timing(device, report)
        elif pid == "4":
            phase_prologue(device, report)
        elif pid == "5":
            phase_main(device, report)
        elif pid == "6":
            fx = phase_notary(device, card)[1]
        elif pid == "7":
            phase_schemes(device, card, fixture())
        elif pid == "8":
            phase_flows(device, card)
        elif pid == "9":
            phase_pool(device, card, fixture())
        elif pid == "10":
            columns["clusters_launches"] = phase_clusters(device, card, fixture())
        elif pid == "11":
            columns["nodes_launches"] = phase_nodes(device, card, fixture())
        elif pid == "12":
            columns["drives_launches"] = phase_drives(device, card)
        elif pid == "13":
            columns["telemetry_launches"] = phase_telemetry(device, card, fixture())["launches"]
        elif pid == "14":
            columns["planes_launches"] = phase_planes(device, card, fixture())["launches"]
        elif pid == "15":
            columns["xshard_launches"] = phase_xshard(device, card, fixture())["launches"]
        elif pid == "16":
            columns["web_launches"] = phase_web(device, card)["launches"]
        elif pid == "17":
            columns["samples_launches"] = phase_samples(device, card)["launches"]
        elif pid == "18":
            columns["fleet_launches"] = phase_tools(device, card)["launches"]
        elif pid == "19":
            columns["shards_launches"] = phase_shards(device, card)["launches"]
        else:
            raise ValueError(f"no phase {pid!r}")
        walls[pid] = round(time.perf_counter() - t, 1)
    return walls, columns


class Lane:
    """A process of this script running the phases `ids` (`--lane`) on
    the card, its output in <root>/lane<k>.out and .err. It writes its
    walls and launch columns to <root>/lane<k>.json, then holds its CUDA
    context until `finish` closes its stdin: the parts that count the
    card's contexts see no lane end under them."""

    def __init__(self, ids, root: str, k: int):
        self.ids, self.log = tuple(ids), os.path.join(root, f"lane{k}")
        self.result = self.log + ".json"
        self.t0, self.wall = time.perf_counter(), None
        with open(self.log + ".out", "w") as out, open(self.log + ".err", "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-u", os.path.abspath(__file__), "--lane", ",".join(ids),
                 "--lane-out", self.result], stdin=subprocess.PIPE, stdout=out, stderr=err,
                cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True)

    def output(self, which: str) -> str:
        with open(f"{self.log}.{which}") as f:
            return f.read()

    def done(self) -> bool:
        """True once the result is written; raises if the lane ended
        without one."""
        if os.path.exists(self.result):
            if self.wall is None:
                self.wall = round(time.perf_counter() - self.t0, 1)
            return True
        if self.proc.poll() is not None:
            raise RuntimeError(f"lane {', '.join(self.ids)} exited {self.proc.returncode} "
                               f"before its result:\n{self.output('out')[-3000:]}\n"
                               f"{self.output('err')[-6000:]}")
        return False

    def finish(self) -> dict:
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=120)
        if rc != 0:
            raise RuntimeError(f"lane {', '.join(self.ids)} exited {rc}: "
                               f"{self.output('err')[-3000:]}")
        with open(self.result) as f:
            return json.load(f)

    def kill(self) -> None:
        """The lane and every process it started (its session)."""
        import signal

        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.proc.wait()


def wait_lanes(lanes, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not all([lane.done() for lane in lanes]):
        if time.monotonic() > deadline:
            raise RuntimeError(f"lanes not done within {timeout:.0f} s: "
                               f"{[lane.ids for lane in lanes if lane.wall is None]}")
        time.sleep(0.5)


def lane_main(ids, out_path: str, device, card: str) -> int:
    """`--lane`: run `ids`, write the result, hold the CUDA context until
    stdin closes (see Lane)."""
    import torch

    torch.zeros(1, device=device)
    walls, columns = run_phases(ids, device, card, {})
    with open(out_path + ".tmp", "w") as f:
        json.dump({"walls": walls, "columns": columns}, f)
    os.replace(out_path + ".tmp", out_path)
    sys.stdin.read()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the kernel table JSON here")
    parser.add_argument("--lane-dir", help="the lanes' logs and results (default: a new "
                        "directory under build/corda_tpu_torch)")
    parser.add_argument("--lane", help=argparse.SUPPRESS)
    parser.add_argument("--lane-out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from corda_tpu_torch import native
    from corda_tpu_torch.crypto import build

    card = _smi("name,power.limit")
    device = torch.device("cuda", 0)
    if args.lane:
        build.build_all()           # the parent's libraries, reused
        native.build_info()
        return lane_main(args.lane.split(","), args.lane_out, device, card)
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.build_info)   # g++ beside the nvcc processes
        libs = build.build_all()
        print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
        info = native_build.result()
    print(f"native: {info.path.name} with {info.compiler}, "
          + (f"built in {info.seconds:.1f} s" if info.built else "reused")
          + f"; SHA-NI {'used' if native.get().sha_ni else 'not used'}")
    for stem in libs:
        for line in build.ptxas_report(stem).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {stem}: {line.strip()}")

    print_resources()
    report: dict = {}
    walls = {"build": round(time.perf_counter() - t0, 1)}
    quiet, _ = run_phases(QUIET, device, card, report)
    walls.update(quiet)

    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    root = args.lane_dir or os.path.join(here, "build", "corda_tpu_torch")
    os.makedirs(root, exist_ok=True)
    root = tempfile.mkdtemp(dir=root, prefix="lanes-")
    os.environ[CARD_LOCK_ENV] = os.path.join(root, "card.lock")
    os.environ["CORDA_TPU_NOTARY_PROFILE"] = "1"    # the notary's phase_seconds, in every lane
    lanes = [Lane(ids, root, k) for k, ids in enumerate(LANES, 1)]
    finished = []
    try:
        home, columns = run_phases(HOME, device, card, report)
        wait_lanes(lanes, LANE_TIMEOUT - (time.perf_counter() - lanes[0].t0))
        finished = [lane.finish() for lane in lanes]
    finally:
        if len(finished) < len(lanes):
            for lane in lanes:
                lane.kill()
    walls.update(home)
    for lane, result in zip(lanes, finished):
        print(f"--- lane {', '.join(lane.ids)} (its own process, beside phases "
              f"{', '.join(HOME)} here) ---")
        sys.stdout.write(lane.output("out"))
        sys.stderr.write(lane.output("err"))
        walls.update(result["walls"])
        columns.update(result["columns"])
    if set(columns) != set(COLUMNS):
        raise RuntimeError(f"launch columns {sorted(columns)} are not {sorted(COLUMNS)}")
    if not args.lane_dir:
        import shutil

        shutil.rmtree(root)     # relayed above; kept only when a run fails
    order = ["build", *QUIET, *sorted((p for p in walls if p not in QUIET and p != "build"),
                                      key=lambda p: (int(p.split()[0]), p))]
    lane_walls = {"here": round(sum(home.values()), 1),
                  **{", ".join(lane.ids): lane.wall for lane in lanes}}
    print(f"phase walls (s): {json.dumps({p: walls[p] for p in order})}; processes after "
          f"phase 4 {json.dumps(lane_walls)}; total "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    for n, r in report.items():
        for col in COLUMNS:
            r[col] = columns[col][n]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", *COLUMNS)
    table = {"kernels": [
        {k: ({"name": n, **r}[k]) for k in keys} for n, r in report.items()
    ]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
