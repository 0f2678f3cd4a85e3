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
        "import mxnet_tpu_torch.symbol, mxnet_tpu_torch.executor\n"
        "import mxnet_tpu_torch.module, mxnet_tpu_torch.module.bulk\n"
        "import mxnet_tpu_torch.metric, mxnet_tpu_torch.lr_scheduler\n"
        "import mxnet_tpu_torch.callback, mxnet_tpu_torch.monitor\n"
        "import mxnet_tpu_torch.model, mxnet_tpu_torch.name\n"
        "import mxnet_tpu_torch.attribute\n"
        "import mxnet_tpu_torch.symbol.legacy_json\n"
        "import mxnet_tpu_torch.dist, mxnet_tpu_torch.parallel.mesh\n"
        "import mxnet_tpu_torch.parallel.tensor, mxnet_tpu_torch._ps\n"
        "import mxnet_tpu_torch.kvstore_server, mxnet_tpu_torch.launch\n"
        "import mxnet_tpu_torch.gradient_compression\n"
        "import mxnet_tpu_torch.ndarray.sparse, mxnet_tpu_torch.ops.extra\n"
        "import mxnet_tpu_torch.recommender\n"
        "import mxnet_tpu_torch.profiler, mxnet_tpu_torch.traceview\n"
        "import mxnet_tpu_torch.traceview.__main__\n"
        "import mxnet_tpu_torch.autotune, mxnet_tpu_torch.analysis\n"
        "import mxnet_tpu_torch.autotune.__main__\n"
        "import mxnet_tpu_torch.analysis.__main__\n"
        "import mxnet_tpu_torch.parallel.scaling\n"
        "import mxnet_tpu_torch.parallel.overlap\n"
        "import mxnet_tpu_torch.rnn, mxnet_tpu_torch.gluon.rnn\n"
        "import mxnet_tpu_torch.ops.rnn, mxnet_tpu_torch.ops.sequence\n"
        "import mxnet_tpu_torch.ops.contrib, mxnet_tpu_torch.ops.extra\n"
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
                                    "tools/torch_collective_cost.py",
                                    "tools/torch_dp_scale.py",
                                    "tools/torch_fit_profile.py",
                                    "tools/torch_kernel_ab.py",
                                    "tools/torch_nd_profile.py",
                                    "tools/torch_serve_profile.py",
                                    "tools/torch_train_profile.py",
                                    "tools/torch_trace_loss.py",
                                    "tools/torch_autotune_scale.py",
                                    "tools/torch_rnn_smoke.py",
                                    "tools/torch_ssd_smoke.py"])
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


def test_sparse_and_recommender_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recommender as rec
    from mxnet_tpu_torch.ndarray import sparse

    for make in (lambda: sparse.zeros("csr", (2, 2)),
                 lambda: sparse.row_sparse_array(np.eye(2)),
                 lambda: mx.nd.zeros((2, 2), stype="row_sparse")):
        with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
            make()
    cfg = rec.RecommenderConfig(n_fields=2, vocab=8, embed_dim=2,
                                mlp_hidden=(4,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rec.init_params(torch.Generator(), cfg)
    with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
        rec.RecommenderTrainStep(cfg, mx.kv.create("local"))
    step = rec.RecommenderTrainStep(cfg, mx.kv.create("local"),
                                    ctx=mx.cpu())
    assert step.device.type == "cpu"
    assert step.dense_params["out_w"].device.type == "cpu"


def test_symbolic_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert

    with mx.name.NameManager():
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=3, name="fc"),
            name="softmax")
    cpu_msg = r"ctx=mx\.cpu\(\)"
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        mx.mod.Module(net)
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        net.simple_bind(data=(2, 4))
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        mx.executor.Executor.simple_bind(net, data=(2, 4))
    args = {"data": mx.nd.zeros((2, 4), ctx=mx.cpu()),
            "fc_weight": mx.nd.zeros((3, 4), ctx=mx.cpu()),
            "fc_bias": mx.nd.zeros((3,), ctx=mx.cpu()),
            "softmax_label": mx.nd.zeros((2,), ctx=mx.cpu())}
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        net.bind(args=args)
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        convert.module_params_from_jax({"w": np.zeros(2)})
    # the CPU when asked for
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind([("data", (2, 4))], [("softmax_label", (2,))])
    assert mod._exec.arg_dict["fc_weight"].context == mx.cpu()
    assert net.bind(mx.cpu(), args=args).forward()[0].shape == (2, 3)
    arg, aux = convert.module_params_from_jax({"w": np.zeros(2)}, {},
                                              ctx=mx.cpu())
    assert arg["w"].context == mx.cpu() and aux == {}
    # an exported block's SymbolBlock.imports places its parameters on
    # the card by default
    blk = mx.gluon.nn.Dense(2, in_units=3, prefix="d_")
    blk.initialize(ctx=mx.cpu())
    path = str(tmp_path / "d")
    blk.export(path)
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        mx.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                     path + "-0000.params")


def test_recurrent_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import numpy as np

    import mxnet_tpu_torch as mx

    cpu_msg = r"ctx=mx\.cpu\(\)"
    layer = mx.gluon.rnn.LSTM(4, num_layers=2, input_size=3)
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        layer.initialize()
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        mx.gluon.rnn.GRUCell(4, input_size=3).initialize()
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        mx.nd.RNN(np.zeros((2, 1, 3)), np.zeros((
            mx.ops.rnn.rnn_param_size(1, 3, 4, mode="gru"),)),
            np.zeros((1, 1, 4)), state_size=4, mode="gru")

    def sym_gen(seq_len):
        cell = mx.rnn.LSTMCell(4, prefix="l_")
        out, _ = cell.unroll(seq_len, mx.sym.Embedding(
            mx.sym.Variable("data"), input_dim=8, output_dim=3, name="e"),
            merge_outputs=True)
        pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, 4)),
                                     num_hidden=8, name="pred")
        return (mx.sym.SoftmaxOutput(pred, mx.sym.Reshape(
            mx.sym.Variable("softmax_label"), shape=(-1,)), name="softmax"),
            ("data",), ("softmax_label",))

    it = mx.rnn.BucketSentenceIter([[1, 2, 3]] * 4 + [[1, 2, 3, 4, 5]] * 4,
                                   batch_size=2, buckets=[3, 5],
                                   invalid_label=0)
    # the iterator's batches are host data whatever the current context
    assert it.next().data[0].context == mx.cpu()
    with pytest.raises(mx.MXNetError, match=cpu_msg):
        mx.mod.BucketingModule(sym_gen, default_bucket_key=5).bind(
            it.provide_data, it.provide_label)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=5,
                                 context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    assert mod._curr_module._exec.arg_dict["l_i2h_weight"].context == \
        mx.cpu()
    with mx.cpu():
        layer.initialize()
        out = layer(mx.nd.zeros((2, 1, 3)))
    assert out.context == mx.cpu() and out.shape == (2, 1, 4)


def test_dist_initialize_picks_nccl_on_a_card_and_raises_without_one(
        monkeypatch, tmp_path):
    from mxnet_tpu_torch import dist

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    # no card: the default (NCCL on the card) raises and names the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist._resolve(None, None, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist._resolve("nccl", "cuda", 0)
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        dist._resolve("nccl", "cpu", 0)
    # asked for the CPU, or for gloo by name: gloo
    assert dist._resolve(None, "cpu", 0) == ("gloo", torch.device("cpu"))
    assert dist._resolve("gloo", None, 0) == ("gloo", torch.device("cpu"))
    # with cards: NCCL on the rank's card (rank modulo the card count)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    assert dist._resolve(None, None, 6) == ("nccl",
                                            torch.device("cuda", 2))
    assert dist._resolve("gloo", "cuda:0", 1) == ("gloo",
                                                  torch.device("cuda", 0))
    # no env contract and no arguments: a single process, no group
    monkeypatch.delenv("MXNET_COORDINATOR_ADDRESS", raising=False)
    assert dist.initialize() is False and not dist.is_initialized()


@pytest.mark.parametrize("launcher", [
    ["-m", "mxnet_tpu_torch.dist", "-n", "2", "--timeout", "120"],
    [str(REPO / "tools" / "launch.py"), "-n", "2", "--launcher", "jax"]],
    ids=["port", "tools_launch_jax"])
def test_launcher_workers_run_the_env_contract_without_jax(tmp_path,
                                                           launcher):
    """``python -m mxnet_tpu_torch.dist -n 2 <cmd>`` (and the JAX
    package's ``tools/launch.py --launcher jax``, which only sets the env
    contract and spawns) starts two ranks; each joins the group (gloo on
    the CPU) and imports no JAX.  A failing rank fails the port's
    launch."""
    code = (
        "import sys\n"
        "from mxnet_tpu_torch import dist\n"
        "from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh\n"
        "assert dist.initialize(device='cpu')\n"
        "m = data_parallel_mesh()\n"
        "assert (m.size, m.rank) == (2, dist.rank())\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu')]\n"
        "assert not bad, bad\n"
        "open(sys.argv[1] + str(dist.rank()), 'w').write('ok')\n"
        "dist.shutdown()\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = str(tmp_path / "rank")
    proc = subprocess.run(
        [sys.executable, *launcher, sys.executable, "-c", code, out],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [Path(out + r).read_text() for r in "01"] == ["ok", "ok"]
    if launcher[0] != "-m":
        return
    failing = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.dist", "-n", "2",
         sys.executable, "-c",
         "import os, sys; sys.exit(3 if os.environ['MXNET_PROCESS_ID'] == "
         "'1' else 0)"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=60)
    assert failing.returncode == 3, failing.stderr


def test_a_dp_mesh_larger_than_the_group_raises():
    from mxnet_tpu_torch.parallel import mesh

    assert mesh.current_device_count() == 1
    for n in (2, 8):
        with pytest.raises(ValueError, match="needs %d ranks" % n):
            mesh.data_parallel_mesh(n)


def test_observability_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    """The device trace records the card unless the caller names the
    CPU; without a card it raises (the profiler's ``profile_xla`` path
    and the step tracer go through it)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.traceview import capture

    with pytest.raises(RuntimeError, match="device='cpu'"):
        capture.start_device_trace(str(tmp_path))
    profiler.set_config(profile_xla=True,
                        xla_trace_dir=str(tmp_path / "x"))
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiler.set_state("run")
        assert not profiler.is_running()
    finally:
        profiler.set_config()
    capture.start_device_trace(str(tmp_path), device="cpu")
    path = capture.stop_device_trace()
    assert path == str(tmp_path / "trace_rank0.pt.trace.json")
    assert capture.stop_device_trace() is None


def test_tuning_entry_points_default_to_cuda_and_raise_without_it():
    """The rank sweep and the overlap measurement start their ranks on
    the card unless the caller names the CPU; without a card they raise
    before starting any."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch.parallel import overlap, scaling

    for call in (lambda: scaling.sweep((1,)),
                 lambda: scaling.control_sweep((1,)),
                 lambda: overlap.measure_overlap()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_detection_entry_points_default_to_cuda_and_raise_without_it():
    """The detection tier's ops, the SSD programs and ``nd.contrib`` run
    on the card unless the caller names the CPU; without a card they
    raise.  On CPU tensors NMS takes its plain route, never the kernel."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import contrib

    import chip_smoke as cs

    calls = (
        lambda: mx.nd.contrib.MultiBoxPrior(mx.nd.zeros((1, 3, 4, 4)),
                                            sizes=(0.5,)),
        lambda: mx.nd.contrib.box_nms(mx.nd.zeros((1, 4, 6))),
        lambda: mx.nd.ROIPooling(mx.nd.zeros((1, 2, 4, 4)),
                                 mx.nd.zeros((1, 5)), pooled_size=(2, 2)),
        lambda: cs.ssd_net(mx, mx.gluon.model_zoo.vision.resnet18_v1())
        .initialize(mx.init.Xavier()),
        lambda: cs.mini_rcnn_net(mx).initialize(mx.init.Xavier()))
    for call in calls:
        with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
            call()
    with pytest.raises(SystemExit, match="no CUDA device"):
        cs.main()
    before = dict(contrib.nms_keep.calls)
    with mx.cpu():
        out = mx.nd.contrib.box_nms(mx.nd.zeros((1, 4, 6)))
    assert out.context == mx.cpu()
    assert contrib.nms_keep.calls["plain"] == before["plain"] + 1
    assert contrib.nms_keep.calls["cuda"] == before["cuda"]
    assert not contrib.nms_keep.launches
