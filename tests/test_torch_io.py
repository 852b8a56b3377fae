"""The port's file formats against the libraries and the JAX package's writers:
safetensors (io/safetensors.py against the `safetensors` package, which the
port may not import), .y4m (io/native.py against the JAX pure-Python
branch), .mp4 (io/mp4.py against JAX's write_mp4), export_video and the
prompt sources. Every comparison is exact: bytes or bits."""

import json
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as st_save_numpy

from sparse_videogen_tpu.io import mp4 as JMP4
from sparse_videogen_tpu.io import native as JNATIVE
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu.utils import dataloader as JDL
from sparse_videogen_tpu_torch.io import mp4 as TMP4
from sparse_videogen_tpu_torch.io import native as TNATIVE
from sparse_videogen_tpu_torch.io import safetensors as TST
from sparse_videogen_tpu_torch.pipelines import wan as TPW
from sparse_videogen_tpu_torch.utils import dataloader as TDL


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a.f32": rng.standard_normal((3, 5)).astype(np.float32),
        "b.bf16": rng.standard_normal((4, 2, 3)).astype(ml_dtypes.bfloat16),
        "c.i64": rng.integers(-2**40, 2**40, (7,)).astype(np.int64),
        "d.f16": rng.standard_normal((2, 2)).astype(np.float16),
        "e.i32": rng.integers(-9, 9, (1, 3)).astype(np.int32),
        "f.u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "g.scalar": np.asarray(1.5, np.float32),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def test_safetensors_reader_reads_library_files_bit_for_bit(tmp_path):
    arrays = _arrays()
    for i, name in enumerate(sorted(arrays)):  # one tensor a file, and all in one file
        st_save_numpy({name: arrays[name]}, str(tmp_path / f"part{i}.safetensors"))
    st_save_numpy(arrays, str(tmp_path / "all.st"), metadata={"format": "np"})
    for got in (TST.load_dir(str(tmp_path)), TST.load_file(str(tmp_path / "all.st"))):
        assert sorted(got) == sorted(arrays)
        for name, a in arrays.items():
            want = a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a
            assert tuple(got[name].shape) == a.shape
            np.testing.assert_array_equal(_bits(got[name]), want)
    assert got["b.bf16"].dtype == torch.bfloat16 and got["c.i64"].dtype == torch.int64


def test_safetensors_writer_reads_back_through_safe_open(tmp_path):
    tensors = {k: torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16
               else torch.from_numpy(np.array(a)) for k, a in _arrays(1).items()}
    tensors["h.strided"] = torch.arange(12, dtype=torch.float32).view(3, 4).t()
    path = str(tmp_path / "ours.safetensors")
    TST.save_file(tensors, path)
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            back = f.get_tensor(name)
            assert back.dtype == t.dtype and back.shape == t.shape
            np.testing.assert_array_equal(_bits(back), _bits(t.contiguous()))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        TST.load_dir(str(tmp_path / "empty"))


def _video(t=4, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 255 // (h + w)], -1)
    return np.clip(base[None] + rng.integers(-40, 41, (t, h, w, 3)), 0, 255).astype(np.uint8)


def test_write_y4m_bytes_equal_jax_python_branch(tmp_path, monkeypatch):
    monkeypatch.setattr(JNATIVE, "_LIB", None)  # the JAX writer's pure-Python branch
    vid = _video()
    JNATIVE.write_y4m(str(tmp_path / "j.y4m"), vid, fps=16)
    TNATIVE.write_y4m(str(tmp_path / "t.y4m"), vid, fps=16)
    assert (tmp_path / "t.y4m").read_bytes() == (tmp_path / "j.y4m").read_bytes()


def test_read_y4m_round_trip_and_load_video(tmp_path):
    vid = _video(t=3)
    path = str(tmp_path / "v.y4m")
    TNATIVE.write_y4m(path, vid, fps=12)
    back, fps = TNATIVE.read_y4m(path)
    jback, jfps = JNATIVE.read_y4m(path)
    assert fps == jfps == 12 and back.shape == vid.shape
    np.testing.assert_array_equal(back, jback)
    # 4:2:0 chroma of noisy frames: the luma is exact up to rounding, colours within the 2x2 means
    assert np.abs(back.astype(np.int32) - vid.astype(np.int32)).mean() < 20
    np.testing.assert_array_equal(TNATIVE.load_video(path), JNATIVE.load_video(path))
    np.save(tmp_path / "v.npy", (vid.astype(np.float32) / 127.5 - 1.0).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(TNATIVE.load_video(str(tmp_path / "v.npy")),
                                  JNATIVE.load_video(str(tmp_path / "v.npy")))


def test_mp4_bytes_equal_jax(tmp_path):
    vid = _video(t=3)
    JMP4.write_mp4(str(tmp_path / "j.mp4"), vid, fps=16)
    TMP4.write_mp4(str(tmp_path / "t.mp4"), vid, fps=16)
    assert (tmp_path / "t.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
    back, fps = TMP4.read_mp4_mjpeg(str(tmp_path / "t.mp4"))
    assert fps == 16
    np.testing.assert_array_equal(back, JMP4.read_mp4_mjpeg(str(tmp_path / "j.mp4"))[0])


def test_mp4_without_pil_names_y4m(tmp_path, monkeypatch):
    """The card's host has no PIL: .mp4 raises ImportError and points at .y4m."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"\.y4m"):
        TMP4.write_mp4(str(tmp_path / "x.mp4"), _video(t=1), fps=16)


@pytest.mark.parametrize("ext", [".y4m", ".mp4"])
def test_export_video_bytes_equal_jax(tmp_path, monkeypatch, ext):
    """(B, 3, T, H, W) in [-1, 1] -> uint8 by truncation, then the writer."""
    monkeypatch.setattr(JNATIVE, "_LIB", None)
    rng = np.random.default_rng(3)
    video = np.clip(rng.standard_normal((1, 3, 3, 16, 24)) * 0.7, -1.0, 1.0).astype(np.float32)
    JPW.export_video(video, str(tmp_path / f"j{ext}"), fps=16)
    TPW.export_video(torch.from_numpy(video), str(tmp_path / f"t{ext}"), fps=16)
    assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()


def test_prompt_sources_equal_jax(tmp_path):
    txt = tmp_path / "prompts.txt"
    txt.write_text("a cat on the grass.\n\n  the grass  \n")
    for idx in (0, 2):
        assert TDL.load_prompt_or_image("T2V_Wan_VBench", idx, str(txt), None) == \
            JDL.load_prompt_or_image("T2V_Wan_VBench", idx, str(txt), None)
    assert TDL.load_prompt_or_image("prompt", 0, "a cat", None) == ("a cat", None)
    js = tmp_path / "p.json"
    js.write_text(json.dumps({"1": {"original": "img", "improved": "a better cat"}}))
    (tmp_path / "img.jpg").write_bytes(b"")
    assert TDL.load_prompt_or_image("I2V_VBench", 1, str(js), str(tmp_path)) == \
        JDL.load_prompt_or_image("I2V_VBench", 1, str(js), str(tmp_path))
    ex = tmp_path / "examples" / "1"
    ex.mkdir(parents=True)
    (ex / "prompt.txt").write_text("a dog\n")
    (ex / "image.png").write_bytes(b"")
    for src in (str(tmp_path / "examples"), str(txt), "a literal prompt"):
        assert TDL.load_prompts(src) == JDL.load_prompts(src)
    with pytest.raises(ValueError):
        TDL.load_prompt_or_image("nope", 0, "x", None)
