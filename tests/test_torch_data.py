"""The port's synthetic data pipeline (``repro_torch.data.pipeline``)
against the reference's (``repro.data.pipeline``): the same batches, bit
for bit, over seeds, steps, shards and world sizes, and after
``reshard``."""
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("seed,vocab,seq,batch,doc_len", [
    (0, 1000, 32, 8, 512),
    (7, 50280, 128, 8, 512),
    (123, 512, 16, 4, 8),          # short documents: many BOS tokens
])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_batches_bit_equal(seed, vocab, seq, batch, doc_len, num_shards):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
              doc_len=doc_len)
    for shard in range(num_shards):
        want = jpipe.SyntheticPipeline(jpipe.DataConfig(**kw), shard,
                                       num_shards)
        got = tpipe.SyntheticPipeline(tpipe.DataConfig(**kw), shard,
                                      num_shards)
        for step in (0, 1, 5, 1000):
            (wt, wl), (gt, gl) = (want.batch(jpipe.DataState(step)),
                                  got.batch(tpipe.DataState(step)))
            assert gt.dtype == wt.dtype == np.int32
            assert gt.shape == (batch // num_shards, seq)
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gt[:, 1:], gl[:, :-1])


def test_advance_and_reshard_match_reference():
    """``advance`` steps the one-integer state; ``reshard`` keeps the step
    and gives the reference's shards at the new world size."""
    kw = dict(vocab_size=1000, seq_len=16, global_batch=8)
    want = jpipe.SyntheticPipeline(jpipe.DataConfig(**kw))
    got = tpipe.SyntheticPipeline(tpipe.DataConfig(**kw))
    ws, gs = jpipe.DataState(), tpipe.DataState()
    for _ in range(3):
        ws, gs = want.advance(ws), got.advance(gs)
    assert gs.step == ws.step == 3
    for shard, n in ((1, 2), (3, 4), (0, 8)):
        wp, ws2 = want.reshard(ws, shard, n)
        gp, gs2 = got.reshard(gs, shard, n)
        assert (gp.shard, gp.num_shards, gs2.step) == (shard, n, 3)
        for a, b in zip(gp.batch(gs2), wp.batch(ws2)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError):
        tpipe.SyntheticPipeline(tpipe.DataConfig(**kw), 0, 3)
