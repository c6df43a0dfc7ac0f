"""The port's sharded commit plane (shards = 4, ShardedUniquenessProvider)
against the reference's, on test_torch_notary.py's fixture: the
dispatch-all-then-consume wave on the port's device path (plain
versions on the CPU), streamed and joined, and the worker-thread plane
on the CPU reference verifiers. Same checks as shards = 1: answer kinds
equal to the labels, byte-equal notary signatures, equal conflicts and
equal committed maps."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import corda_tpu.crypto.batch_verifier as rbv  # noqa: E402
import corda_tpu_torch.crypto.batch_verifier as pbv  # noqa: E402
import corda_tpu_torch.node.notary as pnot  # noqa: E402

from test_torch_notary import (  # noqa: E402,F401  (one_torch_thread: autouse)
    assert_same_answers,
    check_against_reference,
    fixture,
    one_torch_thread,
    run_port,
    run_reference,
)


@pytest.mark.parametrize("streamed", [True, False], ids=["streamed", "join"])
def test_notary_matches_reference_four_shards(streamed):
    svc = check_against_reference(4, streamed)
    fx = fixture()
    homes = {svc.shard_of(s) for s, lab in zip(fx.spends, fx.labels) if lab != "wrong-notary"}
    assert svc.batches_dispatched == len(homes) > 1   # one dispatch per due shard
    assert sum(svc.metrics.counter(f"Notary.Shard{k}.Answered").count for k in range(4)) == sum(
        lab != "wrong-notary" for lab in fx.labels)
    assert svc.uniqueness.partition_depth(0) + svc.uniqueness.partition_depth(1) + \
        svc.uniqueness.partition_depth(2) + svc.uniqueness.partition_depth(3) == len(
            svc.uniqueness.committed)


def test_worker_threads_match_reference():
    fx = fixture()
    r_svc, r_ans = run_reference(rbv.CpuBatchVerifier(), 4, shard_workers=True)
    p_svc, p_ans = run_port(pbv.CpuBatchVerifier(), 4, shard_workers=True)
    try:
        assert_same_answers(r_svc, r_ans, p_svc, p_ans, fx.labels)
    finally:
        r_svc.stop()
        p_svc.stop()
    assert all(not t.is_alive() for t in p_svc._workers)


def test_cross_shard_commit_is_first_wins():
    """A transaction whose inputs live on two partitions takes the
    two-phase reserve→commit; a later one sharing an input loses with
    the full conflict set, and nothing of it is left reserved."""
    fx = fixture()
    uniq = pnot.ShardedUniquenessProvider(4, record_decisions=True)
    refs = [s.wtx.inputs[0] for s in fx.spends]
    by_shard = {}
    for r in refs:
        by_shard.setdefault(uniq.shard_of(r), r)
    a, b = list(by_shard.values())[:2]
    tx1, tx2 = fx.spends[0].id, fx.spends[1].id
    out = uniq.commit_many([([a, b], tx1, fx.requester), ([b], tx2, fx.requester)])
    assert out[0] is None and isinstance(out[1], pnot.UniquenessConflict)
    assert out[1].conflict == {b: tx1}
    assert uniq.committed == {a: tx1, b: tx1}
    assert [d[0] for d in uniq.decisions] == [tx1, tx2]
    assert all(not p.reserved for p in uniq._parts)
