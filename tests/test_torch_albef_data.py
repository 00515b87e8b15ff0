"""The port's ALBEF data layer held against the JAX package's on files the
test writes (``.npy`` images, json annotations): ``RetrievalTrainingDataModule``
(dense image ids, padded text, the shuffled epoch), ``retrieval_eval_data``
and ``VQADataModule`` (the train split's de-duplicated, weighted answers
with a visual-genome sample, the test split's question ids). Both sides use
their own ``CLIPImageTransform`` (the JAX package's through PIL, the port's
through its copy of PIL's resampler): the batches are equal exactly."""

import json

import numpy as np
import pytest

from multimodal_tpu.examples.albef import data as jdata
from multimodal_tpu.transforms.clip_transform import CLIPImageTransform as JImageTransform
from multimodal_tpu_torch.examples.albef import data as tdata
from multimodal_tpu_torch.transforms.clip_transform import CLIPImageTransform


def _tokenize(texts, length=7):
    """A toy tokenizer: [CLS]-like 1, then a letter id each."""
    return np.asarray([[1] + [10 + ord(c) % 50 for c in t.replace(" ", "")[: length - 1]]
                       + [0] * max(0, length - 1 - len(t.replace(" ", "")))
                       for t in texts])


def _images(tmp_path, n):
    r = np.random.RandomState(0)
    paths = []
    for i in range(n):
        p = f"{i}.npy"
        np.save(tmp_path / p, r.randint(0, 256, (40 + 3 * i, 36, 3)).astype(np.uint8))
        paths.append(p)
    return paths


def _equal(jax_batch, port_batch, extra=()):
    assert sorted(jax_batch) == sorted(set(port_batch) - set(extra))
    for k, v in jax_batch.items():
        np.testing.assert_array_equal(port_batch[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_image_transform_matches_jax_on_grey_rgb_and_rgba(channels):
    """The port's CLIPImageTransform (ALBEF's at any size) equals the JAX
    package's, which goes through PIL's ``convert("RGB")``, on a grey, an
    RGB and an RGBA array: grey repeated, alpha dropped."""
    r = np.random.RandomState(4)
    shape = (45, 38) if channels is None else (45, 38, channels)
    image = r.randint(0, 256, shape).astype(np.uint8)
    for is_train in (False, True):
        got = CLIPImageTransform(32, is_train=is_train, rng=np.random.RandomState(2))(image)
        want = JImageTransform(32, is_train=is_train, rng=np.random.RandomState(2))(image)
        assert tuple(got.shape) == (32, 32, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shuffle", [False, True])
def test_retrieval_training_datamodule_matches_jax(tmp_path, shuffle):
    paths = _images(tmp_path, 3)
    ann = [{"image": paths[0], "caption": "a cat", "image_id": "coco_7"},
           {"image": paths[1], "caption": "a dog on a long red mat", "image_id": "coco_9"},
           {"image": paths[0], "caption": "feline pet", "image_id": "coco_7"},
           {"image": paths[2], "caption": "a car", "image_id": "coco_11"}]
    ann_file = tmp_path / "train.json"
    ann_file.write_text(json.dumps(ann))
    kw = dict(text_transform=_tokenize, text_len=5, batch_size=2, prefetch=0, shuffle=shuffle,
              seed=3)
    jdm = jdata.RetrievalTrainingDataModule(str(ann_file), str(tmp_path),
                                            JImageTransform(32, is_train=False), **kw)
    tdm = tdata.RetrievalTrainingDataModule(str(ann_file), str(tmp_path),
                                            CLIPImageTransform(32, is_train=False), **kw)
    assert tdm.idx == jdm.idx == {"coco_7": 0, "coco_9": 1, "coco_11": 2}
    jit, tit = jdm.train_batches(), tdm.train_batches()
    for _ in range(3):  # past the first epoch's two batches
        jb, tb = next(jit), next(tit)
        _equal(jb, tb)
        assert tuple(tb["image"].shape) == (2, 32, 32, 3) and tuple(tb["text"].shape) == (2, 5)


def test_retrieval_eval_data_matches_jax(tmp_path):
    paths = _images(tmp_path, 2)
    ann = [{"image": paths[0], "caption": ["a cat", "feline"], "image_id": "a"},
           {"image": paths[1], "caption": "a dog", "image_id": "b"}]
    ann_file = tmp_path / "test.json"
    ann_file.write_text(json.dumps(ann))
    got = tdata.retrieval_eval_data(str(ann_file), str(tmp_path))
    assert got == jdata.retrieval_eval_data(str(ann_file), str(tmp_path))
    assert got["image_to_text"] == {0: [0, 1], 1: [2]} and got["text_to_image"] == [0, 0, 1]


@pytest.mark.parametrize("split", ["train", "test"])
def test_vqa_datamodule_matches_jax(tmp_path, split):
    paths = _images(tmp_path, 3)
    (tmp_path / "vg").mkdir()
    np.save(tmp_path / "vg" / "g.npy", np.full((30, 30, 3), 7, np.uint8))
    ann = [{"dataset": "vqa", "image": paths[0], "question": "what is it",
            "answer": ["cat", "cat", "dog", "a cat", "cat"], "question_id": 5},
           {"dataset": "vg", "image": "g.npy", "question": "how many", "answer": "two",
            "question_id": 6},
           {"image": paths[2], "question": "which colour is the long car",
            "answer": ["red", "blue", "green", "red"], "question_id": 8},
           {"dataset": "vqa", "image": paths[1], "question": "why",
            "answer": ["x"], "question_id": 9}]
    ann_file = tmp_path / "vqa.json"
    ann_file.write_text(json.dumps(ann))
    answer_list = tmp_path / "answers.json"
    answer_list.write_text(json.dumps(["cat", "dog", "two", "red"]))
    kw = dict(split=split, answer_list=str(answer_list) if split == "test" else None,
              max_answers=3, question_len=6, answer_len=4, batch_size=2, prefetch=0,
              shuffle=False)
    args = (str(ann_file), str(tmp_path), str(tmp_path / "vg"))
    jdm = jdata.VQADataModule(*args, JImageTransform(24, is_train=False), _tokenize, **kw)
    tdm = tdata.VQADataModule(*args, CLIPImageTransform(24, is_train=False), _tokenize, **kw)
    assert tdm.answer_list == jdm.answer_list
    jb, tb = list(jdm.eval_batches()), list(tdm.eval_batches())
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        # the port's train batches also carry each question's answer count
        _equal(a, b, extra=("answer_counts",) if split == "train" else ())
    if split == "train":
        w = tb[0]["answer_weights"].numpy()
        np.testing.assert_allclose(w, [[0.6, 0.2, 0.2], [0.5, 0.0, 0.0]], rtol=1e-6)
        assert tuple(tb[0]["answers"].shape) == (2, 3, 4)
        # three distinct answers (of which max_answers = 3 kept), one; three, one
        assert [b["answer_counts"].tolist() for b in tb] == [[3, 1], [3, 1]]
        for b in tb:  # the rows past the count are padding
            rows = np.arange(3)[None, :] >= b["answer_counts"].numpy()[:, None]
            assert not b["answer_atts"].numpy()[rows].any()
            assert not b["answer_weights"].numpy()[rows].any()
    else:
        assert tb[1]["question_id"].tolist() == [8, 9]


def test_vqa_test_split_needs_an_answer_list(tmp_path):
    (tmp_path / "a.json").write_text("[]")
    with pytest.raises(ValueError, match="answer_list"):
        tdata.VQADataModule(str(tmp_path / "a.json"), "", "", lambda x: x, _tokenize,
                            split="test")
