"""The port's token pipeline against the reference's, bit for bit.

``repro_torch.data`` is a framework-free copy of ``repro.data``: every
batch is numpy made from ``SeedSequence([seed, step, row])``, so the two
must agree exactly, for the global batch, each host's rows and the
prefetch thread's stream.
"""
import numpy as np
import pytest

from repro.data import make_pipeline as jmake
from repro_torch.data import DataConfig, TokenPipeline, make_pipeline


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (128, 32, 4, 0), (151_936, 64, 2, 7), (256_000, 17, 3, 3)])
def test_global_batches_equal_the_reference(vocab, seq, batch, seed):
    mine, ref = (make_pipeline(vocab, seq, batch, seed=seed),
                 jmake(vocab, seq, batch, seed=seed))
    for step in (0, 1, 5, 1000):
        _equal(mine.global_batch(step), ref.global_batch(step))
        _equal(mine[step], ref[step])


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_host_batches_equal_the_reference_and_tile_the_global(n_hosts):
    glob = make_pipeline(128, 32, 8, seed=1).global_batch(3)
    rows = []
    for host in range(n_hosts):
        mine = make_pipeline(128, 32, 8, seed=1, n_hosts=n_hosts,
                             host_id=host)
        ref = jmake(128, 32, 8, seed=1, n_hosts=n_hosts, host_id=host)
        _equal(mine.host_batch(3), ref.host_batch(3))
        rows.append(mine.host_batch(3))
    _equal({k: np.concatenate([r[k] for r in rows]) for k in glob}, glob)


def test_prefetch_streams_the_reference_batches():
    mine, ref = make_pipeline(128, 24, 2, seed=2), jmake(128, 24, 2, seed=2)
    it = mine.prefetch(4, depth=2)
    try:
        for step in range(4, 9):
            _equal(next(it), ref.host_batch(step))
    finally:
        it.close()


def test_config_and_uneven_hosts():
    cfg = DataConfig(vocab=128, seq_len=8, global_batch=6, n_hosts=4)
    with pytest.raises(ValueError, match="divide evenly"):
        TokenPipeline(cfg)
    b = make_pipeline(128, 8, 2).global_batch(0)
    assert set(b) == {"tokens", "labels", "mask"}
    assert b["mask"].dtype == np.float32


def test_long_rows_past_the_reference_buffer():
    """Past seq_len 4 x mean_doc_len + 8 = 2,056 a long last document can
    overrun the reference's buffer: at seq_len 16,384, seed 0, one of the
    first 16 batches raises there.  The port's buffer holds a whole last
    document, so it returns every batch, and wherever the reference
    returns one the two agree bit for bit (the buffer's size changes no
    draw; ROADMAP C5)."""
    mine, ref = make_pipeline(151_936, 16_384, 1, seed=0), \
        jmake(151_936, 16_384, 1, seed=0)
    failed = agreed = 0
    for step in range(16):
        got = mine.global_batch(step)
        assert got["tokens"].shape == (1, 16_384)
        try:
            want = ref.global_batch(step)
        except ValueError as e:
            assert "broadcast" in str(e)
            failed += 1
            continue
        _equal(got, want)
        agreed += 1
    assert failed >= 1 and agreed >= 8
