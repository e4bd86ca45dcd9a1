"""The port's host tier at batch 4 and over a long irregular stream
(tests/test_host_tier.py's batch-4 case and tests/test_soak.py's schedule
to 12x the device store, without its checkpoint), against stc_tpu's
evicting session and the port's all-device session.  Tolerances as in
tests/test_torch_host_tier.py."""

import numpy as np
import pytest
import torch

from test_torch_common import one_thread  # noqa: F401
from test_torch_host_tier import MCFG, Rounds, feed, sessions, start

pytestmark = pytest.mark.usefixtures("one_thread")

# tests/test_soak.py's irregular chunk schedule, in blocks: 396 blocks,
# 12x the 32-page store
SCHEDULE = [1, 4, 2, 4, 1, 2, 4, 4, 2, 1, 4, 4] * 8
QUESTIONS = [[5, 6, 7], [40, 41], [99, 98, 97, 96], [120], [7, 3, 11]]


@pytest.mark.parametrize("quant,chunk", [("none", 1), ("int8", 1),
                                         ("int4", 2)])
def test_hosttier_qa_at_batch4(quant, chunk):
    """Four different streams through the 32-page store, 48 blocks each:
    shared questions (all_streams) and per-stream ones
    (question_answering_batch) answer as stc_tpu's batch-4 evicting
    session does, with the same per-stream retrieved blocks and
    fetch_count; on exact pages also as the all-device port session."""
    j, t = sessions(7, batch=4, max_blocks=32, quant=quant, chunk_size=chunk)
    _, big = sessions(7, batch=4, jax_too=False, max_blocks=256,
                      chunk_size=chunk)
    start((j, t, big))
    feed((j, t, big), np.random.default_rng(7).normal(
        size=(4, 48 * 8, MCFG.hidden_size)).astype(np.float32))
    assert t._evicted_pages == j._evicted_pages > 0
    rounds = Rounds(j)
    for q in ([5, 6, 7], [99, 98, 97, 96]):
        got, want = rounds.ask(t, q, q + [8], [0], max_new_tokens=6,
                               all_streams=True)
        assert got == want, q
        assert len({tuple(a) for a in got}) > 1  # the streams differ
        assert t.last_retrieved_indices == j.last_retrieved_indices
        if quant == "none":
            assert got == big.question_answering(q, q + [8], [0],
                                                 max_new_tokens=6,
                                                 all_streams=True)
    qs = [[5, 6, 7], [40, 41], [99, 98, 97, 96], [120]]
    ps = [q + [8] for q in qs]
    rounds.calls.clear()
    want = j.question_answering_batch(qs, ps, [0], max_new_tokens=6)
    got = t.question_answering_batch(qs, ps, [0], max_new_tokens=6)
    assert got == want
    assert t.qa_rounds == min(len(rounds.calls), 2)
    rounds.within_two &= len(rounds.calls) <= 2
    rounds.check_fetch(t)
    assert t.last_retrieved_indices == j.last_retrieved_indices
    if quant == "none":
        assert got == big.question_answering_batch(qs, ps, [0],
                                                   max_new_tokens=6)
    assert t.host_store.fetch_count > 0


@pytest.mark.parametrize("kv_quant,host", [("none", "none"),
                                           ("int8", "none")])
def test_soak_irregular_schedule_to_12x(kv_quant, host):
    """tests/test_soak.py's schedule: 396 blocks in chunks of 1, 2 and 4
    through the 32-page store (12x), a question every 8 chunks.  Every
    answer equal to stc_tpu's evicting session's (and, on float pages, to
    the all-device port session's); counters and host-tier invariants at
    the end."""
    j, t = sessions(0, max_blocks=32, quant=host, kv_quant=kv_quant,
                    max_rep_blocks=1024)
    _, big = sessions(0, jax_too=False, max_blocks=512, kv_quant=kv_quant,
                      max_rep_blocks=1024)
    start((j, t, big))
    rng = np.random.default_rng(7)
    probes = 0
    rounds = Rounds(j)
    for i, nb in enumerate(SCHEDULE):
        feed((j, t, big), rng.normal(size=(1, nb * 8, MCFG.hidden_size))
             .astype(np.float32))
        if i % 8 == 7:
            q = QUESTIONS[probes % len(QUESTIONS)]
            got, want = rounds.ask(t, q, q + [8], [0], max_new_tokens=5)
            assert got == want, (i, q)
            if j._evicted_pages:  # stc_tpu records them on this path only
                assert t.last_retrieved_indices == j.last_retrieved_indices
            if kv_quant == "none":
                assert got == big.question_answering(q, q + [8], [0],
                                                     max_new_tokens=5)
            probes += 1
    assert probes >= 10
    n_total = sum(SCHEDULE)
    assert t.kvs.num_blocks.unique().tolist() == [n_total]
    assert t.kvs.page_offset.unique().tolist() == [t._evicted_pages]
    assert t._evicted_pages == j._evicted_pages
    assert t._evicted_pages + 32 >= n_total
    assert t.host_store.total_pages == t._evicted_pages
    assert t.host_store.fetch_count > 0
    assert big._evicted_pages == 0
    if kv_quant == "int8":
        assert t.kvs.block_k.dtype == torch.int8
        assert all(c.dtype == torch.int8 for c in t.host_store.k_chunks)
