"""The port's standing rules: ``mxnet_tpu_torch`` imports neither JAX
nor the JAX package (nor ``ml_dtypes``), builds and compiles nothing at
import, and its entry points default to the card and raise without one
instead of dropping to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, mxnet_tpu_torch\n"
        "import mxnet_tpu_torch.serving, mxnet_tpu_torch.transformer\n"
        "import mxnet_tpu_torch.ndarray, mxnet_tpu_torch.autograd\n"
        "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.engine\n"
        "import mxnet_tpu_torch.gluon, mxnet_tpu_torch.optimizer\n"
        "import mxnet_tpu_torch.kvstore, mxnet_tpu_torch.parallel.dp\n"
        "import mxnet_tpu_torch.random, mxnet_tpu_torch.initializer\n"
        "import mxnet_tpu_torch.gluon.model_zoo.vision\n"
        "import mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.diagnostics\n"
        "import mxnet_tpu_torch.chaos, mxnet_tpu_torch.serving.runtime\n"
        "import mxnet_tpu_torch.serving.http\n"
        "import mxnet_tpu_torch.serving.loadgen\n"
        "import mxnet_tpu_torch.serving.__main__\n"
        "import mxnet_tpu_torch.io, mxnet_tpu_torch.remat\n"
        "import mxnet_tpu_torch.transformer.train\n"
        "import mxnet_tpu_torch.transformer.data\n"
        "import mxnet_tpu_torch.parallel.buckets\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu', 'ml_dtypes'))\n"
        # kernels are built at first launch, never at import; NVRTC and
        # the driver are loaded at the first CudaModule
        "rtc = mxnet_tpu_torch.rtc\n"
        "built = sorted(mxnet_tpu_torch._build._libs) + [n for n in "
        "('_nvrtc', '_driver') if getattr(rtc, n) is not None]\n"
        "print(bad, built)\n"
        "raise SystemExit(1 if bad or built else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_package_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, "%s imports %s" % (path.relative_to(REPO), bad)


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/torch_kernel_ab.py",
                                    "tools/torch_nd_profile.py",
                                    "tools/torch_serve_profile.py",
                                    "tools/torch_train_profile.py"])
def test_card_scripts_import_no_jax(script):
    # the scripts run on the machine with the card, which has no JAX
    tree = ast.parse((REPO / script).read_text(), filename=script)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if _forbidden(n)], (script, names)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch import convert, serving
    from mxnet_tpu_torch.transformer import model as tm

    cfg = tm.TransformerConfig(vocab_size=8, n_layers=1, d_model=8,
                               n_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.GenerationRuntime("g", {}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.demo_generation_runtime("g")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax({})
    rt = serving.GenerationRuntime("g", {}, cfg, device="cpu",
                                   max_prompt=16, max_context=16)
    assert rt.device.type == "cpu"
    assert rt.kv.pages["k0"].device.type == "cpu"
    # the predictor tier: runtime, checkpoint-loaded runtime, the CLI
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.demo_runtime()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ModelRuntime("m", lambda p, a, x: x, {},
                             sample_shape=(2,))
    assert serving.demo_runtime(device="cpu").device.type == "cpu"


def test_serving_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch import checkpoint, serving
    from mxnet_tpu_torch.serving import __main__ as cli

    d = str(tmp_path)
    checkpoint.save_checkpoint(d, 1, params=serving.demo_params())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ModelRuntime.from_checkpoint(
            "m", d, lambda p, a, x: x, sample_shape=(16,))
    rt = serving.ModelRuntime.from_checkpoint(
        "m", d, lambda p, a, x: x, sample_shape=(16,), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.demo_generation_runtime("g").successor_from_checkpoint(d)
    assert rt.successor_from_checkpoint(d).device.type == "cpu"
    for argv in (["--serve", "--port", "0"], ["--self-test"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)


def test_arrays_default_to_the_card_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import mxnet_tpu_torch as mx

    assert mx.current_context() == mx.gpu(0) == mx.tpu(0)
    for make in (lambda: mx.nd.array([1.0, 2.0]),
                 lambda: mx.nd.zeros((2,)),
                 lambda: mx.nd.ones((2,), ctx=mx.gpu(0))):
        with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
            make()
    with mx.cpu():
        assert mx.nd.array([1.0, 2.0]).context == mx.cpu()
    assert mx.nd.zeros((2,), ctx=mx.cpu()).context == mx.cpu()


def test_transformer_training_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch import transformer as tr

    cfg = tr.TransformerConfig(vocab_size=8, n_layers=1, d_model=8,
                               n_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.TransformerTrainStep(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.TransformerTrainStep(cfg, device="cuda")
    step = tr.TransformerTrainStep(cfg, device="cpu")
    assert step.device.type == "cpu"
    # the iterator's batches are host data whatever the current context
    batch = tr.LMTokenIter(batch_size=2, seq_len=4, vocab_size=8,
                           num_sequences=4).next()
    assert batch.data[0].context.device_type == "cpu"
    loss = step.step(batch.data[0], batch.label[0])
    assert loss.device.type == "cpu" and torch.isfinite(loss)
