"""The port's quality metrics (utils/metric.py, utils/perceptual.py,
utils/lpips_alex.py) against the JAX package's: the numpy/scipy metrics
bit for bit, the perceptual distances (F.conv2d against XLA's
convolution, f32) within 1e-5 relative, and the two metric CLIs on the
same two .y4m files."""

import json

import numpy as np
import pytest
import torch

from sparse_videogen_tpu.utils import lpips_jax as JL
from sparse_videogen_tpu.utils import metric as JM
from sparse_videogen_tpu.utils import perceptual as JP
from sparse_videogen_tpu_torch.io.native import write_y4m
from sparse_videogen_tpu_torch.utils import lpips_alex as TL
from sparse_videogen_tpu_torch.utils import metric as TM
from sparse_videogen_tpu_torch.utils import perceptual as TP

LPIPS_RTOL = 1e-5


def _videos(seed, shape=(4, 40, 48, 3), noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    return a, np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)


def _alex_weights(seed=0):
    """Random LPIPS-alex weights of the real shapes (torchvision AlexNet's
    features convs, the lpips package's non-negative 1x1 lins)."""
    rng = np.random.default_rng(seed)
    w, c = {}, 3
    for i, (co, k) in enumerate([(64, 11), (192, 5), (384, 3), (256, 3), (256, 3)]):
        w[f"conv{i}_w"] = (rng.standard_normal((co, c, k, k)) * np.sqrt(2 / (c * k * k))).astype(np.float32)
        w[f"conv{i}_b"] = (0.01 * rng.standard_normal(co)).astype(np.float32)
        w[f"lin{i}_w"] = rng.random((1, co, 1, 1)).astype(np.float32)
        c = co
    return w


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_metrics_bit_for_bit(seed):
    a, b = _videos(seed)
    for x, y in ((a[0], b[0]), (a[0, ..., 0], b[0, ..., 0]), (a, a)):
        for mv in (1.0, 2.5):
            assert TM.mse(x, y) == JM.mse(x, y)
            assert TM.psnr(x, y, mv) == JM.psnr(x, y, mv)
            if x.ndim <= 3:
                assert TM.ssim(x, y, mv) == JM.ssim(x, y, mv)
    assert TM.psnr(a, a) == JM.psnr(a, a) == float("inf")
    np.testing.assert_array_equal(TM._gaussian_kernel(), JM._gaussian_kernel())


def test_video_metrics_bit_for_bit():
    """Sequential and in 2 worker processes: the same floats as JAX's."""
    a, b = _videos(2)
    ref = JM.video_metrics(a, b, max_val=1.0)
    assert TM.video_metrics(a, b, max_val=1.0) == ref
    assert TM.video_metrics(a, b, max_val=1.0, workers=2) == ref
    assert TM.video_metrics(a, b, max_val=3.0) == JM.video_metrics(a, b, max_val=3.0)


def test_write_jsonl_and_metrics_mean(tmp_path):
    for name, seed in (("v0", 3), ("v1", 4)):
        frames, mean = TM.video_metrics(*_videos(seed))
        TM.write_jsonl(str(tmp_path / f"{name}.jsonl"), frames, mean)
        JM.write_jsonl(str(tmp_path / f"{name}.ref"), frames, mean)
        assert (tmp_path / f"{name}.jsonl").read_text() == (tmp_path / f"{name}.ref").read_text()
    assert TM.metrics_mean(str(tmp_path)) == JM.metrics_mean(str(tmp_path))
    assert TM.metrics_mean(str(tmp_path / "v0.jsonl")) == {}


def test_random_feature_params_equal():
    for ours, ref in zip(TP.random_feature_params(), JP.random_feature_params()):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape,batch", [((5, 40, 48, 3), 8), ((3, 33, 50, 3), 2)])
def test_lpips_rf_matches_jax(shape, batch):
    a, b = _videos(5, shape)
    ours, ref = TP.lpips_rf(a, b, batch=batch), JP.lpips_rf(a, b, batch=batch)
    assert ours > 0 and abs(ours - ref) <= LPIPS_RTOL * abs(ref)
    assert TP.lpips_rf(a, a) == 0.0


def test_lpips_alex_matches_jax(tmp_path, monkeypatch):
    """A random-weights npz read by both packages through SVT_LPIPS_WEIGHTS."""
    np.savez(tmp_path / "alex.npz", **_alex_weights())
    monkeypatch.setenv("SVT_LPIPS_WEIGHTS", str(tmp_path / "alex.npz"))
    w, jw = TL.load_lpips_weights(), JL.load_lpips_weights()
    assert sorted(w) == sorted(jw) and all(np.array_equal(w[k], jw[k]) for k in w)
    a, b = _videos(6, (3, 80, 96, 3))
    ours, ref = TL.lpips_alex(a, b, w), JL.lpips_alex(a, b, jw)
    assert ours > 0 and abs(ours - ref) <= LPIPS_RTOL * abs(ref)


def test_lpips_weights_from_torch_dir(tmp_path):
    """The .pth directory path (torchvision AlexNet features.* and the lpips
    package's lin*.model.1.weight) and export_npz: the same arrays as JAX's."""
    w = _alex_weights(1)
    alex = {}
    for i, ci in enumerate([0, 3, 6, 8, 10]):
        alex[f"features.{ci}.weight"] = torch.from_numpy(w[f"conv{i}_w"])
        alex[f"features.{ci}.bias"] = torch.from_numpy(w[f"conv{i}_b"])
    torch.save(alex, tmp_path / "alexnet-owt.pth")
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(w[f"lin{i}_w"]) for i in range(5)}, tmp_path / "alex.pth")
    ours, ref = TL.load_lpips_weights(str(tmp_path)), JL.load_lpips_weights(str(tmp_path))
    assert sorted(ours) == sorted(ref) == sorted(w)
    assert all(np.array_equal(ours[k], w[k]) and np.array_equal(ref[k], w[k]) for k in w)
    TL.export_npz(str(tmp_path), str(tmp_path / "out.npz"))
    with np.load(tmp_path / "out.npz") as z:
        assert all(np.array_equal(z[k], w[k]) for k in w)
    with pytest.raises(ValueError, match="npz"):
        TL.load_lpips_weights(str(tmp_path / "alex.pth"))


def test_metric_clis_agree(tmp_path, monkeypatch, capsys):
    """Both CLIs on the same two .y4m files (and the weights npz): the same
    keys, mse / psnr / ssim equal, lpips_rf and lpips within 1e-5; the same
    per-frame JSONL; the directory mode's means equal."""
    a, b = _videos(7, (3, 48, 64, 3), noise=0.1)
    pa, pb = tmp_path / "a.y4m", tmp_path / "b.y4m"
    write_y4m(str(pa), (a * 255).astype(np.uint8))
    write_y4m(str(pb), (b * 255).astype(np.uint8))
    np.savez(tmp_path / "alex.npz", **_alex_weights(2))
    monkeypatch.setenv("SVT_LPIPS_WEIGHTS", str(tmp_path / "alex.npz"))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    TM.main([str(pa), str(pb), "--device", "cpu", "--output_jsonl", str(tmp_path / "t" / "m.jsonl")])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mean"]
    JM.main([str(pa), str(pb), "--output_jsonl", str(tmp_path / "j" / "m.jsonl")])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mean"]
    assert sorted(ours) == sorted(ref) == ["lpips", "lpips_rf", "mse", "psnr", "ssim"]
    assert all(ours[k] == ref[k] for k in ("mse", "psnr", "ssim"))
    assert all(abs(ours[k] - ref[k]) <= LPIPS_RTOL * abs(ref[k]) for k in ("lpips", "lpips_rf"))
    t_lines, j_lines = ((tmp_path / d / "m.jsonl").read_text().splitlines() for d in ("t", "j"))
    assert t_lines[:-1] == j_lines[:-1] and len(t_lines) == 4
    TM.main([str(tmp_path / "j")])
    JM.main([str(tmp_path / "j")])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == out[1]
