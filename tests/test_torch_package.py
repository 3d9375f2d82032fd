"""brotli_tpu_torch stands alone: no jax, nothing of brotli_tpu, and no
silent CPU fallback."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "brotli_tpu_torch")


def test_import_pulls_in_no_jax_and_no_brotli_tpu():
    code = (
        "import sys, brotli_tpu_torch\n"
        "import brotli_tpu_torch.encode.gpu_path, "
        "brotli_tpu_torch.encode.fast, brotli_tpu_torch.ops.parse, "
        "brotli_tpu_torch.ops.match_rounds_cuda, "
        "brotli_tpu_torch.native_bridge, brotli_tpu_torch.ops.split, "
        "brotli_tpu_torch.ops.decode_gpu, "
        "brotli_tpu_torch.decode.batch_gpu, "
        "brotli_tpu_torch.decode.decoder, "
        "brotli_tpu_torch.ops.radix_cuda, "
        "brotli_tpu_torch.research.radix_probe, "
        "brotli_tpu_torch.research.radix_probe2, "
        "brotli_tpu_torch.research.hist8_ab, "
        "brotli_tpu_torch.parallel.mesh, brotli_tpu_torch.entry, "
        "brotli_tpu_torch.utils.profiling, "
        "brotli_tpu_torch.encode.encoder, brotli_tpu_torch.encode.batch, "
        "brotli_tpu_torch.parallel.multi, brotli_tpu_torch.utils.ir, "
        "brotli_tpu_torch.encode.zopfli, brotli_tpu_torch.decode.batch, "
        "brotli_tpu_torch.decode.stream, brotli_tpu_torch.encode.streaming, "
        "brotli_tpu_torch.io_wrappers, brotli_tpu_torch.ffi, "
        "brotli_tpu_torch.utils.analysis, brotli_tpu_torch.utils.billing, "
        "brotli_tpu_torch.utils.prior, brotli_tpu_torch.cli.brotli_cli, "
        "brotli_tpu_torch.cli.catbrotli_cli, "
        "brotli_tpu_torch.encode.metablock, "
        "brotli_tpu_torch.encode.bitstream\n"
        "from brotli_tpu_torch import *\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'brotli_tpu' or "
        "m.startswith('brotli_tpu.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


# brotli_tpu's exports the port has under another name (the counterpart
# of decompress_batch_tpu is decompress_batch_gpu), and the port's own
# names: the device entry points
STILL_TO_PORT = {"decompress_batch_tpu"}
PORT_ONLY = {"compress_fast", "compress_gpu", "compress_mesh",
             "decompress_batch_gpu", "make_mesh", "resolve_device"}


def test_exports_match_jax():
    """The port's __all__ is brotli_tpu's but for the names still to
    port, plus its device entry points; each name resolves."""
    import brotli_tpu
    import brotli_tpu_torch
    port = set(brotli_tpu_torch.__all__)
    assert port - PORT_ONLY == set(brotli_tpu.__all__) - STILL_TO_PORT
    assert PORT_ONLY <= port
    assert not STILL_TO_PORT & port
    for name in port:
        assert getattr(brotli_tpu_torch, name) is not None
    assert brotli_tpu_torch.__version__ == brotli_tpu.__version__


def _python_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", "") == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_no_file_imports_jax_or_brotli_tpu():
    files = _python_files()
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "brotli_tpu"), \
                f"{os.path.relpath(path, ROOT)} imports {mod}"


def test_compress_gpu_without_device_raises_when_cuda_is_absent(
        monkeypatch):
    from brotli_tpu_torch import compress_fast, compress_gpu, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_gpu(b"hello hello hello hello")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_gpu(b"hello hello hello hello", max_device=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_fast(b"hello hello hello hello")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_mesh_and_entry_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    from brotli_tpu_torch import compress_mesh, make_mesh
    from brotli_tpu_torch.entry import dryrun_multichip, entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = b"hello brotli " * 10000
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_mesh(data, n_shards=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(8)
    assert make_mesh(2, device="cpu") == [torch.device("cpu")] * 2


def test_decompress_batch_gpu_without_device_raises_when_cuda_is_absent(
        monkeypatch):
    from brotli_tpu_torch import decompress_batch_gpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decompress_batch_gpu([b"\x3b"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decompress_batch_gpu([b"\x3b"], device="cuda")
    assert decompress_batch_gpu([b"\x3b"], device="cpu") == ([b""], 0)


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py exits non-zero and prints no result off the card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
