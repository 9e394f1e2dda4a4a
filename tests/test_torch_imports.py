"""The port stands alone: no module of repro_torch (nor chip_smoke.py)
imports jax or repro; its entry points never run on the CPU unless
asked; a CUDA tensor never reaches a plain version."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.align import soft
from repro_torch.kernels import build, family, normalizer, wavefront
from repro_torch.train.step import make_sdtw_loss

ROOT = Path(__file__).resolve().parents[1]
GUARD = r"""
import importlib, pkgutil, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"repro_torch must not import {name}")
        return None
sys.meta_path.insert(0, Refuse())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print(" ".join(names))
"""


def test_no_jax_and_no_repro_in_the_port():
    out = subprocess.run(
        [sys.executable, "-c", GUARD, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 25
    assert {"repro_torch.align.soft", "repro_torch.train.step",
            "repro_torch.kernels.backward",
            "repro_torch.core.softdtw", "repro_torch.dp",
            "repro_torch.dp.oracle", "repro_torch.kernels.family"} <= names


def test_every_kernel_source_has_a_build_target():
    """K7 (hard and soft) and bf16-K1 are libraries of their own, each
    from a source in csrc/, built by its own nvcc."""
    assert build.TARGETS["family_wavefront"] == ("family_wavefront.cu",
                                                 ["-fmad=false"])
    assert build.TARGETS["soft_family_wavefront"] == (
        "family_wavefront.cu", ["-DREPRO_SOFT"])
    assert build.TARGETS["wavefront_bf16"] == (
        "wavefront.cu", ["-fmad=false", "-DREPRO_BF16"])
    sources = {src for src, _ in build.TARGETS.values()}
    assert sources == {p.name for p in build.CSRC.glob("*.cu")}
    for src in sources:
        assert (build.CSRC / src).is_file()


class _CardTensor:
    """Stands in for a CUDA tensor: the dispatch reads only .device and
    .requires_grad."""
    device = torch.device("cuda")
    requires_grad = False


def _forbid(*_, **__):
    raise AssertionError("a plain version ran")


def test_no_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(normalizer, "normalize_plain", _forbid)
    monkeypatch.setattr(wavefront, "wavefront_plain", _forbid)
    q = np.zeros((2, 8), np.float32)
    r = np.arange(40, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.sdtw(q, r)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Aligner(r)


def test_cuda_tensor_never_reaches_a_plain_version(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(normalizer, "normalize_plain", _forbid)
    monkeypatch.setattr(wavefront, "wavefront_plain", _forbid)
    monkeypatch.setattr(wavefront, "validate", lambda *a, **k: None)
    launched = []
    monkeypatch.setattr(normalizer, "normalize_cuda",
                        lambda x, eps: launched.append("K2") or x)
    monkeypatch.setattr(wavefront, "wavefront_cuda",
                        lambda *a, **k: launched.append("K1") or a)
    monkeypatch.setattr(family, "family_plain", _forbid)
    monkeypatch.setattr(family, "validate", lambda *a, **k: None)
    monkeypatch.setattr(
        family, "family_cuda",
        lambda *a, spec, **k: launched.append(family.variant(spec)))
    card = _CardTensor()
    assert build.on_card(card)
    normalizer.normalize(card)
    wavefront.wavefront(card, card, n=1, w=8, spec=repro_torch.DPSpec())
    wavefront.wavefront(card, card, n=1, w=8, spec=repro_torch.DPSpec(),
                        compute_dtype=torch.bfloat16)
    for fam, gamma in (("twed", None), ("local", 0.5)):
        family.family_wavefront(card, card, (), n=1, w=8,
                                spec=repro_torch.DPSpec(
                                    family=fam, reduction="softmin"
                                    if gamma else "hardmin"))
    assert launched == ["K2", "K1", "K1", "K7-corner", "K7-soft-cells"]


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(normalizer, "normalize_cuda", _forbid)
    monkeypatch.setattr(wavefront, "wavefront_cuda", _forbid)
    x = torch.ones(2, 5)
    assert not build.on_card(x)
    torch.testing.assert_close(normalizer.normalize(x), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        build.on_card(torch.ones(1, device="meta"))


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone, or with no card, chip_smoke.py exits non-zero and prints no
    verdict.  The card is hidden from the subprocess, so the check holds
    on a machine that has one too."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_soft_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("soft_plain", "checkpoint_plain", "wavefront_plain"):
        monkeypatch.setattr(wavefront, name, _forbid)
    monkeypatch.setattr(normalizer, "normalize_plain", _forbid)
    q = np.zeros((2, 8), np.float32)
    r = np.arange(40, dtype=np.float32)
    for call in (lambda: repro_torch.sdtw(q, r, gamma=0.5),
                 lambda: repro_torch.sdtw(q, r, gamma=0.5,
                                          outputs="soft_alignment"),
                 lambda: repro_torch.Aligner(r, backend="soft"),
                 lambda: make_sdtw_loss(r, gamma=0.5),
                 lambda: soft.expected_alignment(
                     q, r, spec=repro_torch.DPSpec(reduction="softmin")),
                 lambda: soft.soft_costs(q, r)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cuda_tensor_never_reaches_a_soft_plain_version(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("soft_plain", "checkpoint_plain"):
        monkeypatch.setattr(wavefront, name, _forbid)
    monkeypatch.setattr(wavefront, "validate", lambda *a, **k: None)
    launched = []
    monkeypatch.setattr(
        wavefront, "soft_cuda", lambda *a, reverse=False, checkpoint=False,
        **k: launched.append(wavefront.soft_variant(reverse, checkpoint)))
    card = _CardTensor()
    spec = repro_torch.DPSpec(reduction="softmin")
    wavefront.soft_wavefront(card, card, n=1, w=8, spec=spec)
    wavefront.soft_checkpoint(card, card, n=1, w=8, spec=spec)
    wavefront.soft_checkpoint(card, card, n=1, w=8, spec=spec, reverse=True)
    assert launched == ["K5", "K6-forward", "K6-reverse"]
    with pytest.raises(ValueError, match="softmin spec"):
        wavefront.soft_wavefront(card, card, n=1, w=8,
                                 spec=repro_torch.DPSpec())
