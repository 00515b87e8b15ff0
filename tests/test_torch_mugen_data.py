"""The port's MUGEN data module and recall eval
(multimodal_tpu_torch/examples/mugen/{data,retrieval_train}.py) held against
the JAX package: frames and token rows from one seed (random starts and
texts in training, past an epoch; fixed ones in validation; the recipe's
hash fallback and ``BertTextTransform`` on a vocab file), and
``build_retrieval_eval``'s recalls against the JAX recipe's arithmetic,
equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.mugen import retrieval_train as jrt
from multimodal_tpu.training.retrieval_eval import retrieval_recall_at_k
from multimodal_tpu_torch.examples.mugen import retrieval_train as trt


def _write_split(root, split, n, frames, rng):
    data = []
    for i in range(n):
        vid = f"{split}_{i}"
        t = frames[i % len(frames)]
        np.save(root / f"{vid}.npy", rng.randint(0, 256, (t, 6, 8, 3)).astype(np.uint8))
        data.append({"video": {"id": vid, "num_frames": t},
                     "annotations": [{"text": f"mugen jumps over gap {i}"},
                                     {"text": f"mugen collects coin {i}"}]})
    (root / f"{split}.json").write_text(json.dumps({"metadata": {}, "data": data}))


@pytest.fixture()
def mugen_files(tmp_path):
    rng = np.random.RandomState(8)
    # 10 frames is too short for 4 samples every 3rd: filtered out
    _write_split(tmp_path, "train", 6, (12, 20, 10, 15), rng)
    _write_split(tmp_path, "val", 5, (11, 16), rng)
    words = sorted({w for i in range(6) for w in f"mugen jumps over gap collects coin {i}".split()})
    (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", *words]))
    return tmp_path


def _cfg(root, **data):
    d = {**jrt.DEFAULTS["data"], "path": str(root), "frames_dir": str(root),
         "sequence_length": 4, "sample_every_n_frames": 3, "text_len": 8, "batch_size": 2,
         "eval_batch_size": 2, "seed": 3, **data}
    return {"model": {**jrt.DEFAULTS["model"], "vocab_size": 500}, "data": d,
            "train": dict(jrt.DEFAULTS["train"])}


@pytest.mark.parametrize("vocab", [False, True])
def test_datamodule_frames_and_texts_match_jax(mugen_files, vocab):
    """Random starts and annotations (train) and fixed ones (val) from the
    same seed: the same frames and token rows (the hash fallback and
    ``BertTextTransform`` on a vocab file)."""
    cfg = _cfg(mugen_files, vocab_path=str(mugen_files / "vocab.txt") if vocab else None)
    for split in ("train", "val"):
        jdm, tdm = jrt.build_datamodule(cfg, split), trt.build_datamodule(cfg, split)
        assert len(tdm.dataset) == len(jdm.dataset)
        if split == "train":
            jit, tit = iter(jdm.train_batches()), iter(tdm.train_batches())
            pairs = [(next(jit), next(tit)) for _ in range(4)]  # past an epoch
        else:
            pairs = list(zip(jdm.eval_batches(), tdm.eval_batches()))
        for want, got in pairs:
            np.testing.assert_array_equal(got["video"].numpy(), want["video"])
            np.testing.assert_array_equal(got["text"].numpy(), want["text"])
    r, want_r = np.random.RandomState(0), np.random.RandomState(0)
    idx = trt.build_datamodule(cfg, "train").frame_indices(20, r)
    assert list(idx) == list(want_r.randint(0, 20 - 9) + np.arange(4) * 3)


class _Towers(torch.nn.Module):
    """Stand-in towers for the eval's plumbing and arithmetic (the real
    towers are held against JAX in ``test_torch_mugen_retrieval.py``): a
    fixed projection of each clip's pixels and of each text's token counts."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.video = torch.nn.Parameter(torch.randn(4 * 6 * 8 * 3, 16, generator=g))
        self.text = torch.nn.Parameter(torch.randn(64, 16, generator=g))

    def encode_video(self, video):
        return torch.nn.functional.normalize(video.flatten(1) @ self.video, dim=-1)

    def encode_text(self, text):
        counts = torch.zeros(text.shape[0], 64).scatter_add_(
            1, text.long() % 64, torch.ones(text.shape, dtype=torch.float32))
        return torch.nn.functional.normalize(counts @ self.text, dim=-1)


def test_recall_eval_matches_jax(mugen_files):
    """``build_retrieval_eval`` over the val split against the JAX
    recipe's arithmetic (``retrieval_recall_at_k`` over the JAX data
    module's batches) on the same embeddings."""
    cfg = _cfg(mugen_files, vocab_path=str(mugen_files / "vocab.txt"))
    towers = _Towers()
    got = trt.build_retrieval_eval(cfg)(towers)
    v_emb, t_emb = [], []
    with torch.no_grad():
        for batch in jrt.build_datamodule(cfg, "val").eval_batches():
            v_emb.append(towers.encode_video(torch.from_numpy(batch["video"])).numpy())
            t_emb.append(towers.encode_text(torch.from_numpy(batch["text"])).numpy())
    recalls = retrieval_recall_at_k(jnp.asarray(np.concatenate(v_emb)),
                                    jnp.asarray(np.concatenate(t_emb)))
    assert set(got) == {f"{d}_recall_{k}" for d in ("v2t", "t2v") for k in (1, 5, 10)}
    assert 0 < got["v2t_recall_1"] < 1  # the embeddings rank something
    for d, s in (("v2t", "a2b"), ("t2v", "b2a")):
        for k in (1, 5, 10):
            assert got[f"{d}_recall_{k}"] == pytest.approx(float(recalls[f"{s}_recall_{k}"]),
                                                          abs=1e-6)
