"""``python -m sykepic_tpu_torch train --device cpu`` end to end on a tiny
PNG set (the config of ``tests/test_train_loop.py``): every artifact is
written; the JAX package's ``load_variables`` reads the port's
``best_state.msgpack`` and the Flax model's eval logits on it equal the
port's within 1e-5; the port's inference engine loads the directory;
resume continues in the same directory; the test report is scikit-learn's
text for the same labels."""

import configparser
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import classification_report as sk_report

from sykepic_tpu.models import checkpoint as jax_checkpoint
from sykepic_tpu.train import config as jax_config
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.analyze import report
from sykepic_tpu_torch.models import checkpoint
from sykepic_tpu_torch.train import config as tcfg
from sykepic_tpu_torch.train import loop

CONFIG = """
[dataset]
path = {dataset}
split = 0.6, 0.2, 0.2
external_test =
min_N =
max_N =
exclude =
random_seed = 42
oversample_until = 12
oversample_with_decay =

[model]
path = {models}
network = resnet18
weights =
id = auto
exist_ok = no
head = 32
dropout = -1, 0.25

[image]
shape = 3, 32, 32
augmentations = flip, translate, zoom, brightness
imagenet_normalization = {norm}
border = mode
zoom_range = 0.8, 1.2
brightness_range = 0.95, 1.1
max_rotation = 10
batch_size = 8
num_workers = 2

[train]
max_epochs = 2
early_stop_patience = 3
learning_rate = 0.01
optimizer = Adam

[lr_warmup]
use = yes
factor_1 = 0.1
factor_2 = 0.5
step_1 = 1
step_2 = 2
step_3 = 3

[lr_reduction]
use = yes
factor = 0.1
patience = 2
"""


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dataset(root):
    rng = np.random.default_rng(0)
    for name, base in [("dark", 30), ("bright", 220), ("striped", 0)]:
        d = root / name
        d.mkdir(parents=True)
        for i in range(10):
            h, w = int(rng.integers(20, 40)), int(rng.integers(15, 30))
            img = np.full((h, w), base, np.uint8)
            if name == "striped":
                img[::2] = 255
            img = np.clip(img.astype(int) + rng.integers(-10, 10, img.shape),
                          0, 255).astype(np.uint8)
            cv2.imwrite(str(d / f"{name}_{i:02}.png"), img)
    return root


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("train")
    ini = tmp / "train.ini"
    ini.write_text(CONFIG.format(dataset=_dataset(tmp / "dataset"),
                                 models=tmp / "models", norm="no"))
    calls = []
    original = loop.classification_report

    def record(y_true, y_pred, names):
        calls.append((list(y_true), list(y_pred), list(names)))
        return original(y_true, y_pred, names)

    loop.classification_report = record
    try:
        model_dir = main(["train", str(ini), "--device", "cpu"])
    finally:
        loop.classification_report = original
    return model_dir, calls, tmp


def test_artifacts(trained):
    model_dir, _, _ = trained
    assert model_dir.name == "resnet18_1"
    for f in ("best_state.msgpack", "config.ini", "train_state.pt",
              "train_stats.png", "test_report.txt"):
        assert (model_dir / f).is_file(), f
    names = (model_dir / "class_names.txt").read_text().splitlines()
    assert names == ["bright", "dark", "striped"]
    dist = (model_dir / "class_distribution.csv").read_text()
    assert dist.splitlines()[0] == \
        "class,total,train,validation,test,oversampled"
    state = torch.load(model_dir / "train_state.pt", weights_only=True)
    assert state["epoch"] == 2
    assert state["schedule"]["stage"] == 1
    assert state["opt_state"]["count"] > 0


def test_report_is_sklearns(trained):
    model_dir, calls, _ = trained
    (y_true, y_pred, names), = calls
    assert len(y_true) == 6
    text = (model_dir / "test_report.txt").read_text()
    assert text == sk_report(y_true, y_pred, labels=list(range(len(names))),
                             target_names=names, zero_division=0)


@pytest.mark.parametrize("seed", range(4))
def test_report_equals_sklearn_on_random_labels(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    y_true = rng.integers(0, n, 200)
    y_pred = np.where(rng.random(200) < 0.5, y_true, rng.integers(0, n, 200))
    names = [f"class_{'x' * int(rng.integers(0, 14))}{k}" for k in range(n)]
    assert report.classification_report(y_true, y_pred, names) == sk_report(
        y_true.tolist(), y_pred.tolist(), labels=list(range(n)),
        target_names=names, zero_division=0)


def test_jax_package_reads_the_checkpoint(trained):
    model_dir, _, _ = trained
    tree = jax_checkpoint.load_variables(model_dir / "best_state.msgpack")
    config = jax_config.read_config(model_dir / "config.ini")
    jmodel, _ = jax_config.get_network(config, 3)
    x = np.random.default_rng(1).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(tree, jnp.asarray(x), train=False))

    port_cfg = tcfg.read_config(model_dir / "config.ini")
    model, _ = tcfg.get_network(port_cfg, 3)
    _, dropout = tcfg.get_head_spec(port_cfg)
    model.load_state_dict(checkpoint.load_model_state(model_dir, dropout))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_engine_loads_trained_dir(trained):
    from sykepic_tpu_torch.compute.engine import Classifier

    model_dir, _, _ = trained
    clf = Classifier(model_dir, batch_size=8, device="cpu")
    assert clf.classes == ["bright", "dark", "striped"]
    (_, roi_id, probs), = clf.classify_rois(
        [(0, 1, np.full((24, 20), 220, np.uint8))])
    assert roi_id == 1 and probs.shape == (3,)
    assert np.isclose(probs.sum(), 1.0, atol=1e-5)


def test_resume_continues_in_same_dir(trained, tmp_path):
    model_dir, _, _ = trained
    work = tmp_path / "models"
    shutil.copytree(model_dir, work / model_dir.name)
    resumed = work / model_dir.name
    cfg = configparser.ConfigParser()
    cfg.read(resumed / "config.ini")
    cfg.set("model", "path", str(work))
    cfg.set("train", "resume", "yes")
    cfg.set("train", "max_epochs", "3")
    ini = tmp_path / "resume.ini"
    with open(ini, "w") as fh:
        cfg.write(fh)
    state_path = resumed / "train_state.pt"
    state = torch.load(state_path, weights_only=True)
    # a high historical best: the resumed epoch must not overwrite it
    state["metrics"]["max_val_acc"] = 1.0
    torch.save(state, state_path)
    best = resumed / "best_state.msgpack"
    marker = best.read_bytes()
    out = main(["train", str(ini), "--device", "cpu"])
    assert out == resumed
    after = torch.load(state_path, weights_only=True)
    assert after["epoch"] == 3 and after["schedule"]["stage"] == 2
    assert after["opt_state"]["count"] > state["opt_state"]["count"]
    assert best.read_bytes() == marker


def test_rotation_trains_and_missing_card_raises(trained, tmp_path):
    _, _, tmp = trained
    text = (tmp / "train.ini").read_text().replace(
        "flip, translate, zoom, brightness",
        "flip, translate, zoom, rotate, brightness").replace(
        f"path = {tmp / 'models'}", f"path = {tmp_path / 'models'}").replace(
        "max_epochs = 2", "max_epochs = 1")
    (tmp_path / "rot.ini").write_text(text)
    model_dir = main(["train", str(tmp_path / "rot.ini"), "--device", "cpu"])
    state = torch.load(model_dir / "train_state.pt", weights_only=True)
    assert state["epoch"] == 1 and state["opt_state"]["count"] > 0
    assert np.isfinite(state["metrics"]["min_val_loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["train", str(tmp / "train.ini")])


def test_imagenet_normalisation_trains(trained, tmp_path):
    _, _, tmp = trained
    ini = tmp_path / "norm.ini"
    ini.write_text(CONFIG.format(dataset=tmp / "dataset",
                                 models=tmp_path / "models", norm="yes")
                   .replace("max_epochs = 2", "max_epochs = 1"))
    model_dir = main(["train", str(ini), "--device", "cpu"])
    assert (model_dir / "best_state.msgpack").is_file()


def test_load_pretrained_resolves_weights(trained, tmp_path):
    model_dir, _, _ = trained
    model, _ = tcfg.get_network(tcfg.read_config(model_dir / "config.ini"),
                                5)  # another class count: the head stays
    fresh = checkpoint.to_flax_variables(model.state_dict())
    best = model_dir / "best_state.msgpack"
    merged = checkpoint.load_pretrained(fresh, str(best), "resnet18")
    saved = checkpoint.load_variables(best)
    np.testing.assert_array_equal(merged["params"]["conv1"]["kernel"],
                                  saved["params"]["conv1"]["kernel"])
    np.testing.assert_array_equal(merged["params"]["head"]["fc1"]["kernel"],
                                  fresh["params"]["head"]["fc1"]["kernel"])
    # a reference-layout .pth of the same weights merges the same backbone
    pth = tmp_path / "w.pth"
    _, dropout = tcfg.get_head_spec(tcfg.read_config(model_dir / "config.ini"))
    torch.save(checkpoint.load_model_state(model_dir, dropout), pth)
    from_pth = checkpoint.load_pretrained(fresh, str(pth), "resnet18")
    np.testing.assert_array_equal(from_pth["batch_stats"]["bn1"]["var"],
                                  saved["batch_stats"]["bn1"]["var"])
    assert checkpoint.load_pretrained(fresh, None, "resnet18") is fresh
    with pytest.raises(FileNotFoundError):
        checkpoint.load_pretrained(fresh, str(tmp_path / "no.msgpack"),
                                   "resnet18")
    with pytest.raises(RuntimeError, match="allow_random_init"):
        checkpoint.load_pretrained(fresh, "IMAGENET1K_V1", "resnet18")
    assert checkpoint.load_pretrained(fresh, "DEFAULT", "resnet18",
                                      allow_random_init=True) is fresh
