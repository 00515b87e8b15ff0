"""Checkpoint and resume in the port: ``training/checkpoint.py``'s
``CheckpointManager`` (a step a directory, moved into place whole, the
newest ``max_to_keep`` kept) and the ``Trainer``'s ``restore_or_init`` /
``fit(checkpoint_every=...)``. A resumed run is held bitwise equal, on the
CPU, to the uninterrupted one: N steps against N/2, save, a new model,
optimizer and trainer, restore, N/2 more; for a small model with dropout
and gradient accumulation, for the FLAVA recipe on synthetic and on real
data (fp32 AdamW and pure bf16 with AnyPrecision AdamW) and for the LM
recipe.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.examples.flava import pretrain as trec
from multimodal_tpu_torch.examples.long_context import train as lm_train
from multimodal_tpu_torch.training import checkpoint as ckpt_mod
from multimodal_tpu_torch.training.checkpoint import CheckpointManager
from multimodal_tpu_torch.training.trainer import Trainer

DEBUG_YAML = os.path.join(os.path.dirname(trec.__file__), "configs", "debug.yaml")


def test_save_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": 4, "acc": [None, torch.ones(2)],
             "nested": {"t": (1, 2.5, "x")}}
    mgr.save(4, state)
    mgr.save(9, {"w": torch.zeros(1), "step": 9})
    assert mgr.steps() == [4, 9] and mgr.latest_step() == 9
    got = mgr.restore(4)
    assert torch.equal(got["w"], state["w"]) and got["step"] == 4
    assert got["acc"][0] is None and torch.equal(got["acc"][1], torch.ones(2))
    assert got["nested"] == {"t": (1, 2.5, "x")}
    assert mgr.restore()["step"] == 9


def test_max_to_keep_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 5):
        mgr.save(step, {"step": step})
    assert mgr.steps() == [3, 5]
    assert sorted(os.listdir(tmp_path)) == ["3", "5"]
    mgr.save(5, {"step": 50})  # the same step again replaces it
    assert mgr.restore(5)["step"] == 50 and mgr.steps() == [3, 5]
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), max_to_keep=0)


def test_killed_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    """A save that dies while writing (here: the file is half written, then
    the writer raises) leaves the previous step as the newest, readable;
    its temporary directory is never taken for a step."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"w": torch.ones(3), "step": 2})
    real_save = torch.save

    def dying_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 half a checkpoint")
        raise KeyboardInterrupt("killed")

    monkeypatch.setattr(ckpt_mod.torch, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(4, {"w": torch.zeros(3), "step": 4})
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    assert any(n.startswith(".tmp-4-") for n in os.listdir(tmp_path))
    os.makedirs(tmp_path / "7")  # a step directory without its file does not count either
    fresh = CheckpointManager(str(tmp_path))
    assert fresh.latest_step() == 2
    assert torch.equal(fresh.restore()["w"], torch.ones(3))


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(6, 16)
        self.b = torch.nn.Linear(16, 1)

    def forward(self, x):
        return self.b(torch.nn.functional.dropout(torch.relu(self.a(x)), 0.3, self.training))


def _net_run(steps, ckpt_dir=None, every=None, restore=False):
    torch.manual_seed(0)
    model = _Net()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.1)
    trainer = Trainer(lambda m, b: (((m(b["x"]) - b["y"]) ** 2).mean(), {}), opt, device="cpu",
                      grad_accum_steps=2, checkpoint_dir=ckpt_dir, log_interval=100)
    torch.manual_seed(1)  # the RNG the run's dropout starts from
    if restore:
        trainer.restore_or_init(model)
    r = np.random.RandomState(3)
    data = [{"x": r.randn(4, 6).astype(np.float32), "y": r.randn(4, 1).astype(np.float32)}
            for _ in range(8)]
    trainer.fit(model, data[trainer.step:steps], steps - trainer.step, checkpoint_every=every)
    return model, trainer


def test_trainer_resume_is_bitwise(tmp_path):
    """Dropout (the torch RNG), gradient accumulation over 2 steps caught
    half way (step 3 of 6) and AdamW's state all come back: the parameters
    and the losses of steps 4-7 equal the uninterrupted run's."""
    whole, wt = _net_run(7)
    _net_run(3, str(tmp_path), every=3)
    resumed, rt = _net_run(7, str(tmp_path), restore=True)
    assert rt.step == 7
    assert [r["loss"] for r in rt.logger.records] == [r["loss"] for r in wt.logger.records[3:]]
    for (n, a), b in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n


def _flava(tmp, steps, *extra):
    model, trainer = trec.main(["--device", "cpu", "--config", DEBUG_YAML, f"train.steps={steps}",
                                "data.batch_size=4", "train.log_interval=100", *extra])
    return model, trainer, [r for r in trainer.logger.records if "loss" in r]


@pytest.fixture(scope="module")
def real_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    r = np.random.RandomState(1)
    words = "a cat dog on the mat red blue sky".split()
    with open(root / "pairs.jsonl", "w") as f:
        for i in range(12):
            path = str(root / f"{i}.npy")
            np.save(path, r.randint(0, 256, (48, 40, 3)).astype(np.uint8))
            f.write(json.dumps({"image": path, "text": " ".join(r.choice(words, 6))}) + "\n")
    return str(root / "pairs.jsonl")


@pytest.mark.parametrize("data,pure_bf16", [("synthetic", False), ("real", False),
                                            ("real", True)])
def test_flava_pretraining_resume_is_bitwise(data, pure_bf16, real_data, tmp_path):
    """The recipe's ``main`` for 5 steps saving every 2 (steps 2 and 4);
    step 4's checkpoint taken away, as if the run were killed after step 2's
    save; a second ``main`` on the directory resumes at step 2, skips the 2
    batches trained on and trains the remaining 3 under the same schedule:
    every parameter and the losses of steps 3-5 bitwise equal to the whole
    run's. With real data the six losses' inputs include the dVAE's labels;
    ``pure_bf16`` trains bf16 weights with AnyPrecision AdamW."""
    extra = [f"train.pure_bf16={str(pure_bf16).lower()}", f"train.checkpoint_dir={tmp_path}",
             "train.checkpoint_every=2", "train.warmup_steps=1"]
    if data == "real":
        extra.append(f"data.path={real_data}")
    whole, _, whole_records = _flava(tmp_path, 5, *extra)
    want = {k: v.clone() for k, v in whole.state_dict().items()}
    assert CheckpointManager(str(tmp_path)).steps() == [2, 4]
    shutil.rmtree(tmp_path / "4")
    resumed, trainer, records = _flava(tmp_path, 5, *extra)
    assert trainer.step == 5 and [r["step"] for r in records] == [3, 4, 5]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "items_per_sec"} for r in recs]
    assert strip(records) == strip(whole_records[2:])
    if data == "real":
        assert "mmm_image_loss" in records[0]
    sd = resumed.state_dict()
    for k, v in want.items():
        assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k
    if pure_bf16:
        assert whole.model.image_encoder.embeddings.patch_projection.weight.dtype == \
            torch.bfloat16


def test_flava_resume_past_the_end_trains_nothing(tmp_path):
    """A run restarted on a finished run's checkpoint trains no step."""
    ck = f"train.checkpoint_dir={tmp_path / 'ck'}"
    _flava(tmp_path, 2, ck, "train.checkpoint_every=1")
    _, trainer, records = _flava(tmp_path, 2, ck)
    assert trainer.step == 2 and records == []


def test_lm_recipe_resume_is_bitwise(tmp_path):
    """The LM recipe's ``--checkpoint-dir``: 4 packed steps against 2 saved
    steps and a resumed run of the remaining 2."""
    args = ["--device", "cpu", "--packed-docs", "synthetic", "--seq-len", "64",
            "--batch-size", "2", "--n-layer", "1", "--d-model", "64", "--n-head", "2",
            "--vocab-size", "64"]
    whole, wt = lm_train.main(args + ["--steps", "4"])
    ck = ["--checkpoint-dir", str(tmp_path / "lm"), "--checkpoint-every", "2"]
    lm_train.main(args + ["--steps", "2"] + ck)
    resumed, rt = lm_train.main(args + ["--steps", "4"] + ck)
    assert rt.step == 4
    assert [r["loss"] for r in rt.logger.records] == [r["loss"] for r in wt.logger.records[2:]]
    for (n, a), b in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n
