"""Host-sharded loading: train/data.host_shard_rows and
sharded_data_iterator against the JAX package's (train/data.py:296-357).
host_shard_rows gives JAX's slices for every host of 1, 2 and 4 (a batch
the hosts do not divide raises in both, ValueError here, AssertionError
there). sharded_data_iterator at the 'data' coordinate d of D (a mesh
object; no processes) yields exactly the rows JAX's yields on process d
of D (jax.process_index / process_count stand in, and the assembly of
the global array returns the process's own rows) over an epoch of 19
rows in global batches of 8, with drop_last (two batches) and without
(the last one of 3 rows wrap-padded with the epoch's first indices to a
multiple of D); the D shards of each batch put together are the
single-process iterator's batch."""

import numpy as np
import pytest
import torch

from video_llava_tpu.parallel import make_mesh as jmake_mesh
from video_llava_tpu.train import data as jdata
from video_llava_tpu_torch.parallel.mesh import Mesh
from video_llava_tpu_torch.train import data as pdata


class DS:
    def __len__(self):
        return 19

    def __getitem__(self, i):
        return {"input_ids": np.full((8,), i, np.int32),
                "labels": np.full((8,), -i, np.int32)}


def _collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def test_host_sharded_rows_match_jax(monkeypatch):
    rows = np.random.default_rng(0).permutation(16)
    for n in (1, 2, 4):
        for p in range(n):
            np.testing.assert_array_equal(pdata.host_shard_rows(rows, p, n),
                                          jdata.host_shard_rows(rows, p, n))
    with pytest.raises(ValueError, match="not divisible"):
        pdata.host_shard_rows(np.arange(10), 0, 4)
    with pytest.raises(AssertionError):
        jdata.host_shard_rows(np.arange(10), 0, 4)

    import jax

    monkeypatch.setattr(jax, "make_array_from_process_local_data",
                        lambda sharding, arr: arr)
    for n in (2, 4):
        monkeypatch.setattr(jax, "process_count", lambda n=n: n)
        for drop_last in (True, False):
            shards = []
            for p in range(n):
                monkeypatch.setattr(jax, "process_index", lambda p=p: p)
                want = list(jdata.sharded_data_iterator(
                    DS(), _collate, 8, np.random.default_rng(0),
                    jmake_mesh(n, None), drop_last=drop_last))
                got = list(pdata.sharded_data_iterator(
                    DS(), _collate, 8, np.random.default_rng(0), "cpu",
                    mesh=Mesh(n, 1, data_rank=p), drop_last=drop_last))
                assert len(got) == len(want) == (2 if drop_last else 3)
                for w, g in zip(want, got):
                    for k in w:
                        assert g[k].dtype == torch.int32
                        np.testing.assert_array_equal(g[k].numpy(), w[k])
                shards.append(got)
            whole = list(pdata.data_iterator(DS(), _collate, 8,
                                             np.random.default_rng(0),
                                             drop_last=drop_last))
            for i, w in enumerate(whole):
                ids = np.concatenate([s[i]["input_ids"].numpy()
                                      for s in shards])
                np.testing.assert_array_equal(ids[:len(w["input_ids"])],
                                              w["input_ids"])
                # wrap-padding: the epoch's first rows after the last
                np.testing.assert_array_equal(
                    ids[len(w["input_ids"]):],
                    whole[0]["input_ids"][:len(ids) - len(w["input_ids"])])
