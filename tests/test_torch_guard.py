"""Guards of the port: it never imports JAX or the reference package; only
``repro_torch/net`` opens sockets or starts processes (the reference's
``tests/test_api_guard.py`` rule); and without CUDA its entry points refuse
to run unless asked for the CPU."""
import ast
import re
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib")


def _port_files():
    return sorted(PORT.rglob("*.py")) + sorted(ROOT.glob("chip_*.py"))


def _bad_import(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN or name == "repro" or name.startswith("repro.")


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 20 and (PORT / "serve" / "engine.py") in files
    assert ROOT / "chip_smoke.py" in files
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                bad += [(f, a.name) for a in node.names if _bad_import(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _bad_import(node.module or ""):
                    bad.append((f, node.module))
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                  == "import_module" and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and _bad_import(str(node.args[0].value))):
                bad.append((f, node.args[0].value))
    assert not bad, bad


# transport primitives: sockets and process creation (test_api_guard.py)
_NET_BANNED = re.compile(
    r"(\bimport\s+socket\b|\bfrom\s+socket\s+import"
    r"|\bimport\s+socketserver\b|\bfrom\s+socketserver\s+import"
    r"|\bimport\s+http\.server\b|\bfrom\s+http\.server\s+import"
    r"|\bimport\s+multiprocessing\b|\bfrom\s+multiprocessing\s+import"
    r"|\bos\.fork\b|\bpty\.fork\b"
    r"|\bimport\s+subprocess\b|\bfrom\s+subprocess\s+import)"
)
# The one exception: the kernel build runs nvcc, one compiler process per
# CUDA source, which is a build step and carries no parcel — as the
# reference's dry-run compiler driver runs its compile cells.
_NET_ALLOWED_FILES = {PORT / "kernels" / "_build.py"}


def test_no_sockets_or_process_creation_outside_net():
    """Only repro_torch/net talks to the OS about wires and processes:
    everything that crosses a process boundary is a parcel on the
    parcelport — one wire format, one set of counters, one shutdown path."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        if PORT / "net" in path.parents or path in _NET_ALLOWED_FILES:
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if _NET_BANNED.search(line):
                offenders.append(f"{path.relative_to(PORT)}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
    assert any(_NET_BANNED.search(line)
               for line in (PORT / "kernels" / "_build.py").read_text().splitlines())
    net_files = [p.name for p in sorted((PORT / "net").glob("*.py"))
                 if any(_NET_BANNED.search(line) for line in p.read_text().splitlines())]
    assert net_files == ["httpd.py", "locality.py", "parcelport.py"]


def test_net_guard_matches_known_spellings():
    for bad in ("import socket", "from socket import socketpair",
                "import multiprocessing as mp", "os.fork()",
                "import subprocess", "from subprocess import run",
                "from http.server import ThreadingHTTPServer",
                "import socketserver"):
        assert _NET_BANNED.search(bad), bad
    for ok in ("websocket_url = 1", "# talks over a socket", "forked = True",
               "import socketserver_shim"):
        assert not _NET_BANNED.search(ok), ok


def test_guard_catches_reference_imports():
    assert _bad_import("repro") and _bad_import("repro.core.future")
    assert _bad_import("jax.numpy") and _bad_import("jaxlib")
    assert not _bad_import("repro_torch.core") and not _bad_import("torch")


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a machine without CUDA")


def test_entry_points_refuse_cpu_without_being_asked(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.router import Router

    cfg = get_config("starcoder2_3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    scfg = ServeConfig(max_batch=1, cache_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(model, params, scfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Router.replicate(model, params, scfg, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        Engine(model, params, scfg, device="meta")


def test_launcher_refuses_cpu_without_flag(no_cuda):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "starcoder2_3b", "--smoke", "--requests", "1"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_training_entry_points_refuse_cpu_without_being_asked(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config("starcoder2_3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    model = build_model(cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, AdamWConfig(), DataConfig(), TrainConfig())
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "starcoder2_3b", "--smoke", "--steps", "1"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_wrappers_never_fall_back(no_cuda):
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                      paged_decode_attention_fwd)
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    from repro_torch.kernels.stream import stream_triad_fwd

    m = torch.empty(1, 16, 2, 16, device="meta")
    h = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(m, m, m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.paged_decode_attention(m[:, 0], m, m, m[:, :, 0, 0].int(),
                                   m[:, 0, 0, 0].int())
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.decode_attention(m[:, 0], m, m, 3)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd_scan(m, m[..., 0], h, m, m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rglru_scan(m[0], m[0])
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.stream_triad(m[0, 0, 0], m[0, 0, 0])
    x = torch.zeros(1, 16, 2, 16)  # CPU tensors never reach a kernel
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        paged_decode_attention_fwd(x[:, 0], x, x, torch.zeros(1, 1, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_fwd(x[:, 0], x, x, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan_fwd(x, x[..., 0], torch.zeros(2), x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        rglru_scan_fwd(x[0], x[0])
    with pytest.raises(ValueError, match="CUDA device"):
        stream_triad_fwd(x[0, 0, 0], x[0, 0, 0])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


def test_chip_smoke_fails_without_cuda(no_cuda, tmp_path):
    """No card → non-zero exit and no result line, from the checkout and
    from a directory holding the script alone."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120,
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"})
        assert r.returncode != 0, r.stdout
        assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_2b", "whisper_small",
                                  "internvl2_2b"])
def test_new_architectures_build_on_cpu_only_when_asked(no_cuda, arch):
    """Both configs (full and smoke) come from the registry; the model
    builds on the CPU when asked and refuses without CUDA otherwise."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model

    full, smoke = get_config(arch), get_config(arch, smoke=True)
    assert full.name == arch and smoke.name == f"{arch}_smoke"
    assert get_config(arch.replace("_", "-")) == full
    assert build_model(smoke, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(smoke)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(full)


def test_unported_families_raise_naming_the_family():
    """Every family and architecture of the reference is ported: a made-up
    family raises ``NotImplementedError`` naming it, an unknown arch
    ``KeyError``."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ARCH_IDS, NOT_PORTED
    from repro_torch.models.model import Model

    cfg = replace(get_config("starcoder2_3b", smoke=True), family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        Model(cfg, device="cpu")
    with pytest.raises(KeyError, match="unknown arch 'whisper_large'"):
        get_config("whisper_large")
    assert NOT_PORTED == [] and {"whisper_small", "internvl2_2b"} <= set(ARCH_IDS)
