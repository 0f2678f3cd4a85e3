"""The host-side helpers of ``chip_smoke.py``, on the CPU: the parsing
of ``cuobjdump -sass`` and ``-res-usage`` output that the ``build``
phase checks the wgmma kernels with, the rtc add's grid, the row-scaled
error the flash rows are held to, and the attention bound; for the
transformer phases, the head-scaled error of the backward rows, the
backward's bound, the step's FLOP count and the profile's kernel groups;
for the symbolic phases, the symbol ``fit`` trains (the JAX package's
``bench._sym_resnet50``, byte for byte), the phase order, and the
``fit_numerics`` checks on the CPU; for the observability phases, their
place in ``main`` and the smoke's own reading of a torch.profiler trace
(launches and busy ms a step window) against ``traceview.parse``.  The
script itself needs a card and refuses to run without one."""
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs

REPO = Path(__file__).resolve().parent.parent

WG64 = ("_ZN50_GLOBAL__N__d04745e8_17_flash_attn_fwd_cu_3c61d8562wg15"
        "flash_fwd_wgmmaILi64EEEv14CUtensorMap_stS2_S2_S2_iiiiifi")
SIMT = ("_ZN50_GLOBAL__N__d04745e8_17_flash_attn_fwd_cu_3c61d85616"
        "flash_fwd_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PS2_iiiiiil")


@pytest.mark.parametrize("mangled,label", [
    (WG64, "flash_fwd_wgmma<64>"),
    (SIMT, "flash_fwd_kernel<bf16,128>"),
    ("_ZN1_16flash_fwd_kernelIfLi64EEEvPKT_", "flash_fwd_kernel<f32,64>"),
    ("some_other_kernel", "some_other_kernel")])
def test_kernel_labels(mangled, label):
    assert cs._kernel_label(mangled) == label


def test_sass_counts_per_kernel():
    sass = "\n".join([
        "\t\tFunction : %s" % WG64,
        "        /*0a10*/  UTMALDG.4D [UR8], [UR4] ;",
        "        /*0b20*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0b30*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;",
        "        /*0c00*/  UTMASTG.4D [UR4], [UR6] ;",
        "\t\tFunction : %s" % SIMT,
        "        /*0010*/  FFMA R1, R2, R3, R1 ;"])
    assert cs._sass_counts(sass) == {
        "flash_fwd_wgmma<64>": {"HGMMA": 2, "UTMALDG": 1, "UTMASTG": 1},
        "flash_fwd_kernel<bf16,128>": {"HGMMA": 0, "UTMALDG": 0,
                                       "UTMASTG": 0}}


def test_res_usage_reads_registers_stack_and_local():
    text = "\n".join([
        "Resource usage:", " Common:", "  GLOBAL:0",
        " Function %s:" % WG64,
        "  REG:104 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:1012 TEXTURE:0",
        " Function %s:" % SIMT,
        "  REG:168 STACK:16 SHARED:0 LOCAL:16 CONSTANT[0]:520"])
    assert cs._res_usage(text) == {
        "flash_fwd_wgmma<64>": {"REG": 104, "STACK": 0, "LOCAL": 0},
        "flash_fwd_kernel<bf16,128>": {"REG": 168, "STACK": 16,
                                       "LOCAL": 16}}


@pytest.mark.parametrize("n,blocks", [
    (1, 1), (1024, 1), (1025, 2), (2 ** 20 + 3, 1025), (2 ** 26, 132 * 8),
    (8 * 128, 1)])
def test_add_grid_is_resident_and_strides(n, blocks):
    # at most 8 blocks of 256 an SM; 4 elements a thread up to that
    grid, block = cs._add_grid(n)
    assert grid == (blocks, 1, 1) and block == (256, 1, 1)


def _attn(T, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((1, T, 2, D), generator=g) for _ in range(3))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v), s, v


def test_row_scaled_err_passes_bf16_rounding():
    want, _, _ = _attn(512, 64)
    got = want.to(torch.bfloat16)
    assert (got.float() - want).abs().max() > 0
    assert cs.row_scaled_err(got, want) < cs.ROW_RTOL[torch.bfloat16]


def test_row_scaled_err_catches_a_dropped_last_tile():
    # a late causal row that lost its last 64 keys: small in absolute
    # terms next to the early rows, large against its own magnitude
    want, s, v = _attn(512, 64)
    p = s.softmax(-1)
    p[..., 448:, 448:] = 0
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    got = torch.einsum("bhqk,bkhd->bqhd", p, v)
    assert cs.row_scaled_err(got, want) > cs.ROW_RTOL[torch.bfloat16]


def test_row_scaled_err_holds_zero_rows_to_zero():
    want = torch.zeros((1, 4, 2, 64))
    assert cs.row_scaled_err(want.clone(), want) == 0
    got = want.clone()
    got[0, 1, 0, 3] = 1e-3
    assert cs.row_scaled_err(got, want) > 1


def test_attention_bound_at_the_serving_cell():
    ms, by = cs.attention_bound(4, 512, 512, 12, 64, True, torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 4 * 12 * 64 * 4 * 512 / 3.35e12 * 1e3)
    ms, by = cs.attention_bound(1, 200, 200, 12, 64, True, torch.float32)
    assert by == "operations"


def test_the_script_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_train_tflops_counts_three_forwards_an_image():
    # 3 forwards of 4.09 G multiply-adds (2 FLOP each) an image: batch 128
    # in 0.1 s
    assert cs.train_tflops(128, 0.1) == pytest.approx(
        3 * 2 * 4.09e9 * 128 / 0.1 / 1e12)


def test_update_err_is_relative_to_the_update():
    w0 = {"a": np.zeros(4), "b": np.ones(2)}
    want = {"a": np.full(4, 0.5), "b": np.full(2, 2.0)}   # norm sqrt(3)
    assert cs._update_err(want, want, w0) == 0
    got = dict(want, a=want["a"] + np.array([0.02, 0, 0, 0]))
    assert cs._update_err(got, want, w0) == pytest.approx(0.02 / 3 ** 0.5)


def test_the_training_phases_run_before_the_kernel_line():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_ndarray()", "phase_train()",
                                     "phase_train_numerics()",
                                     '"phase": "kernels"')]
    assert order == sorted(order)


def _numerics_net(seed=0):
    """A small conv net with BatchNorm on the CPU, its shapes settled."""
    import mxnet_tpu_torch as mx

    nn = mx.gluon.nn
    np.random.seed(seed)
    net = nn.HybridSequential(prefix="num_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(5))
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.nd.zeros((2, 3, 8, 8)))
    return net


def _numerics_reference():
    rng = np.random.RandomState(3)
    data = rng.uniform(0, 1, (2, 4, 3, 8, 8))
    label = rng.randint(0, 5, (2, 4)).astype(np.float64)
    net = _numerics_net()
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    aux = {k for k, p in net.collect_params().items()
           if p.grad_req == "null"}
    ref, ref_p = cs.numerics_run(net, w0, data, label, "float64")
    return net, w0, aux, data, label, ref, ref_p


def test_the_float64_trajectory_check_passes_a_rerun():
    net, w0, _, data, label, ref, ref_p = _numerics_reference()
    got, got_p = cs.numerics_run(_numerics_net(), w0, data, label,
                                 "float64")
    loss_err, upd_err = cs.check_trajectory(got, got_p, ref, ref_p, w0)
    assert (loss_err <= cs.TRAJ_LOSS_RTOL).all()
    assert (upd_err <= cs.TRAJ_UPDATE_TOL).all()


@pytest.mark.parametrize("fault", ["step2_skipped",
                                   "step2_without_momentum"])
def test_the_float64_trajectory_check_fails_a_step_two_fault(fault):
    # the faults run for real: the reading matches fault_update_errs,
    # which chip_smoke checks on the card's reference run, and the
    # trajectory check refuses it
    net, w0, aux, data, label, ref, ref_p = _numerics_reference()
    if fault == "step2_skipped":
        got, got_p = ref, [ref_p[0], ref_p[0]]
    else:
        # momentum 0 from the start: step 1 has no momentum to apply,
        # so only step 2 differs
        got, got_p = cs.numerics_run(_numerics_net(), w0, data, label,
                                     "float64", momentum=0.0)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-12)
    _, upd_err = cs.trajectory_errors(got, got_p, ref, ref_p, w0)
    assert upd_err[1] == pytest.approx(
        cs.fault_update_errs(ref_p, w0, aux)[fault], rel=1e-9)
    assert upd_err[1] > 1e3 * cs.TRAJ_UPDATE_TOL
    with pytest.raises(RuntimeError, match="float64 parameters' update"):
        cs.check_trajectory(got, got_p, ref, ref_p, w0)


@pytest.mark.parametrize("fault", sorted(cs.LM_ATTN_FAULTS))
def test_the_lm_update_check_fails_a_planted_attention_fault(fault,
                                                            monkeypatch):
    # train_lm_numerics' planted faults, at its widths on a smaller
    # batch (2 x 32 tokens), on the CPU in float64: dropping one
    # attention input's gradient moves the update more than ten times
    # LM_NUM_UPDATE_TOL (dk ~1.1e-2, dv ~0.36 here), while a rerun
    # matches to rounding
    monkeypatch.setattr(cs, "LM_NUM_BATCH", 2)
    monkeypatch.setattr(cs, "LM_NUM_SEQ", 32)
    cfg = cs.lm_config(**cs.LM_NUM, dtype="float64", param_dtype="float64")
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    w0 = TransformerTrainStep(cfg, device="cpu", seed=0).params_numpy()
    ref, ref_p = cs._lm_numerics_run(cfg, "cpu", w0, 2)
    again, again_p = cs._lm_numerics_run(cfg, "cpu", w0, 2)
    bad, bad_p = cs._lm_numerics_run(cfg, "cpu", w0, 2, attn_fault=fault)
    _, same = cs.trajectory_errors(again, again_p, ref, ref_p, w0)
    np.testing.assert_allclose(bad[0], ref[0], rtol=1e-12)
    _, upd_err = cs.trajectory_errors(bad, bad_p, ref, ref_p, w0)
    assert (same <= 1e-12).all()
    assert upd_err.max() > 10 * cs.LM_NUM_UPDATE_TOL


def test_the_serving_phases_follow_serve_and_precede_the_kernel_line():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_serve()", "phase_serve_http(",
                                     "phase_loadgen(", "phase_reload(",
                                     "phase_serve_cli()",
                                     '"phase": "kernels"')]
    assert order == sorted(order)


def test_stream_client_dechunks_and_resets_a_live_server():
    """The raw-socket streaming client the serve_http phase drives,
    against the port's HTTP front end on the CPU: a full stream ends in
    the terminal line, and a client that resets after 2 tokens leaves
    no KV blocks behind."""
    from mxnet_tpu_torch import serving

    rt = serving.demo_generation_runtime(
        "g_smoke", n_layers=1, slots=2, block_tokens=16, max_prompt=16,
        max_context=64, max_new=40, prefill_batch=2, device="cpu")
    srv = serving.ModelServer(default_deadline_ms=30_000)
    srv.add_generator(rt)
    fe = serving.HttpFrontend(srv, port=0)
    host, port = fe.start()
    try:
        t0, lines = cs._stream_generate(host, port, "g_smoke",
                                        {"prompt": [3, 4], "max_new": 5})
        toks = [o["token"] for _, o in lines if "token" in o]
        assert lines[-1][1] == {"done": True, "tokens": 5, "prompt_len": 2}
        assert len(toks) == 5 and all(t >= t0 for t, _ in lines)
        _, cut = cs._stream_generate(host, port, "g_smoke",
                                     {"prompt": [3, 4], "max_new": 40},
                                     stop_after=2)
        assert len(cut) == 2
        deadline = time.monotonic() + 60.0
        while rt.kv.stats()["blocks_live"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert rt.kv.stats()["blocks_live"] == 0
    finally:
        srv.drain(timeout_s=10.0)
        fe.stop()


BWD_WGMMA = ("_ZN50_GLOBAL__N__4bd607fe_17_flash_attn_bwd_cu_3b68708a2wg"
             "19flash_bwd_dkv_wgmmaILi128EEEv14CUtensorMap_stS2_S2_S2_S2_S2_"
             "PKfS4_iiiifffi")
BWD_SIMT = ("_ZN50_GLOBAL__N__4bd607fe_17_flash_attn_bwd_cu_3b68708a12"
            "flash_bwd_dqI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_S4_PKfPfPS2_"
            "iiiiiiNS_7StridesEfi")


def test_backward_kernel_labels():
    assert cs._kernel_label(BWD_WGMMA) == "flash_bwd_dkv_wgmma<128>"
    assert cs._kernel_label(BWD_SIMT) == "flash_bwd_dq<bf16,64>"


def test_head_scaled_error_ignores_rows_that_cancel():
    want = torch.ones((1, 4, 2, 8))
    want[:, 0] = 0.0                       # a row that cancels to zero
    got = want.clone()
    got[:, 0] = 1e-6                       # its rounding
    assert cs.head_scaled_err(got, want) == pytest.approx(1e-6)
    got[0, 2, 1, 3] += 0.5                 # one head off by half its scale
    assert cs.head_scaled_err(got, want) == pytest.approx(0.5)


def test_attention_backward_bound_at_the_train_shape():
    # 5 products of 2*D FLOPs over the 524800 causal pairs a head: 32.2
    # GFLOP, 0.0326 ms at 989 TFLOP/s; the bytes (q, k, v, o, dO read,
    # dq, dk, dv written, lse) take 0.0301 ms
    ms, by = cs.attention_bwd_bound(8, 1024, 1024, 12, 64, True,
                                    torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(0.03260, rel=1e-3)
    assert cs.causal_pairs(1024, 1024, True) == 1024 * 1025 // 2
    assert cs.causal_pairs(3, 5, True) == 3 + 4 + 5
    assert cs.causal_pairs(5, 3, True) == 0 + 0 + 1 + 2 + 3
    assert cs.causal_pairs(4, 6, False) == 24
    ms32, by32 = cs.attention_bwd_bound(2, 300, 200, 12, 64, True,
                                        torch.float32)
    assert by32 == "operations" and ms32 > 0


def test_lm_step_flops_and_kernel_groups():
    cfg = cs.lm_config()
    n = 32000 * 768 + 12 * (768 * 2304 + 768 * 768 + 2 * 768 * 3072
                            + 2 * 768) + 768
    flops = cs.lm_step_flops(cfg, n, 8, 1024)
    attn = 12 * 8 * 12 * 64 * (1024 * 1025 // 2) * 12
    assert flops == pytest.approx(6 * n * 8 * 1024 + attn)
    assert flops == pytest.approx(5.848e12, rel=1e-3)
    assert cs.lm_kernel_group(BWD_WGMMA) == "attention_bwd"
    assert cs.lm_kernel_group(
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>"
    ) == "gemm_f32_head"
    assert cs.lm_kernel_group("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"
                              ) == "gemm_bf16"
    assert cs.lm_kernel_group("flash_fwd_wgmma<64>") == "attention_fwd"


def test_the_fit_symbol_is_the_bench_symbol():
    import bench
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    with jmx.name.NameManager():
        want = bench._sym_resnet50(1000).tojson()
    with tmx.name.NameManager():
        got = cs.sym_resnet50(1000).tojson()
    assert got == want
    with tmx.name.NameManager():
        cut = cs.sym_resnet50(cs.FIT_NUM["classes"])
    shapes = cut.infer_shape(data=(cs.FIT_NUM["batch"], 3,
                                   cs.FIT_NUM["image"], cs.FIT_NUM["image"]))
    assert shapes[1] == [(cs.FIT_NUM["batch"], cs.FIT_NUM["classes"])]


def test_the_symbolic_phases_run_before_the_kernel_line():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_train_lm_numerics()",
                                     "phase_fit()", "phase_fit_numerics()",
                                     "phase_export()", '"phase": "kernels"')]
    assert order == sorted(order)
    assert '"fit": fit["kernel_launches"]' in main


@pytest.fixture
def restore_bulk_size():
    """The phase sets the port's bulk size; an explicit one would leak
    into later tests of this process: restore the engine as it was."""
    from mxnet_tpu_torch import engine

    saved = engine._bulk_size, engine._bulk_explicit
    yield
    engine._bulk_size, engine._bulk_explicit = saved


def test_fit_steps_on_the_cpu_agree_and_see_a_skipped_step(
        restore_bulk_size):
    """The fit_numerics check, card replaced by a second CPU run: two
    float64 Module.fit steps agree bitwise, bulk K=2 equals per-batch,
    and a skipped step 2 reads far above the limit."""
    import mxnet_tpu_torch as mx

    X, y = cs._fit_data(2, 32, 4, 2, seed=7)
    X = X.astype(np.float64)
    with mx.name.NameManager():
        sym = cs.sym_resnet50(4)
    start = mx.mod.Module(sym, context=mx.cpu())
    start.bind([("data", (2, 3, 32, 32))], [("softmax_label", (2,))])
    cs._cast_module(start, torch.float64)
    np.random.seed(0)
    start.init_params(mx.init.Xavier())
    w0, aux0 = start.get_params()
    flat0 = {k: v.asnumpy() for k, v in list(w0.items()) + list(aux0.items())}
    saved = dict(cs.FIT_NUM)
    cs.FIT_NUM.update(batch=2, classes=4)
    try:
        a, a_loss, _ = cs._fit_steps(mx.cpu(), w0, aux0, X, y, 1)
        b, b_loss, _ = cs._fit_steps(mx.cpu(), w0, aux0, X, y, 1)
        bulk, _, bmod = cs._fit_steps(mx.cpu(), w0, aux0, X, y, 2)
    finally:
        cs.FIT_NUM.update(saved)
    assert bmod._bulk_loop.groups == 1
    assert [cs._update_err(p, q, flat0) for p, q in zip(a, b)] == [0.0, 0.0]
    np.testing.assert_array_equal(a_loss, b_loss)
    for k in a[-1]:
        np.testing.assert_array_equal(bulk[-1][k], a[-1][k])
    assert cs._update_err(a[0], a[1], flat0) > 1e3 * cs.FIT_NUM_TOL


def test_the_dp_phases_follow_export_and_precede_the_kernel_line():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_export()", "phase_dp(train)",
                                     "phase_dp_numerics()",
                                     "phase_train_lm_dp(lm)",
                                     "phase_train_lm_dp_numerics()",
                                     '"phase": "kernels"')]
    assert order == sorted(order)
    for path in ('"dp": dp_counts', '"train_lm_dp": lm_dp_counts'):
        assert path in main


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Kernel:
    def __init__(self, name, start, end):
        from torch.autograd import DeviceType

        self.name, self.time_range = name, _Range(start, end)
        self.device_type = DeviceType.CUDA


def test_nccl_stats_count_the_all_reduce_time_compute_does_not_hide():
    events = [_Kernel("conv", 0, 100), _Kernel("ncclDevKernel_AR", 50, 150),
              _Kernel("bn", 140, 160), _Kernel("ncclKernel_AG", 200, 210),
              _Kernel("gemm", 205, 300)]
    got = cs._nccl_stats(events, steps=2)
    assert got["nccl_launches_per_step"] == 1.0
    assert got["launches_per_step"] == 2.5
    # 50-100 under conv, 140-150 under bn; 205-210 under gemm
    assert got["nccl_exposed_ms_per_step"] == pytest.approx(
        (40 + 5) / 1e3 / 2)
    assert got["nccl_device_ms_per_step"] == pytest.approx(110 / 1e3 / 2)
    assert cs._nccl_stats([_Kernel("conv", 0, 10)], 1)[
        "nccl_exposed_ms_per_step"] == 0.0


def test_digest_tells_one_bit_apart():
    a = {"w": np.arange(4.0), "b": np.ones(2)}
    b = {"b": np.ones(2), "w": np.arange(4.0)}
    assert cs._digest(a) == cs._digest(b)
    b["w"] = b["w"].copy()
    b["w"].view(np.int64)[1] ^= 1
    assert cs._digest(a) != cs._digest(b)


def test_the_planted_dp_faults_read_above_the_limit_and_undo_themselves():
    """dp_numerics's faults on two gloo CPU ranks (the conv net of the
    dp parity tests): a rank that keeps its own gradient, and sync BN's
    backward without its all-reduce, each move the trajectory far past
    DP_NUM_TOL; a clean run after them equals the clean run before."""
    import torch_dp_cases as cases
    from mxnet_tpu_torch import dist

    rng = np.random.RandomState(1)
    data = rng.uniform(-1, 1, (2, 4, 3, 8, 8)).astype(np.float32)
    label = rng.randint(0, 5, (2, 4)).astype(np.float32)
    import mxnet_tpu_torch as mx

    np.random.seed(0)
    with mx.cpu():
        net = cases.conv_net(mx)
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.nd.array(data[0][:2]))
    spec = dict(data=data, label=label, w0=cases.params_of(net),
                step=dict(learning_rate=0.1, momentum=0.9, dtype="float64"))
    ranks = dist.launch(cases.fault_cases, 2, (spec,), device="cpu",
                        threads=1, timeout_s=300)
    w0 = spec["w0"]
    for r, got in enumerate(ranks):
        for k, v in got.items():
            assert "error" not in v, v
        clean = got["clean"]
        assert all(np.array_equal(clean[k], got["after"][k]) for k in clean)
        assert cs._update_err(got["sync_bn_backward_local"], clean, w0) > \
            1e3 * cs.DP_NUM_TOL
    assert cs._update_err(ranks[1]["grad_not_reduced"], ranks[1]["clean"],
                          w0) > 1e3 * cs.DP_NUM_TOL


def test_the_sp_phases_follow_the_dp_phases_and_precede_the_kernel_line():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_train_lm_dp_numerics()",
                                     "phase_train_lm_sp()",
                                     "phase_train_lm_sp_numerics()",
                                     "phase_module_dp_numerics()",
                                     '"phase": "kernels"')]
    assert order == sorted(order)
    # the flash kernels' rows read both, the NMS kernel's row the
    # numerics' (the per-step counts hold the flash kernels only)
    assert main.count("sp_counts.items()") == 2
    assert main.count("sp_num_counts.items()") == 3


def test_the_planted_ring_faults_read_above_the_limit_and_undo_themselves():
    """train_lm_sp_numerics's faults on two gloo CPU ranks (the LM of
    tests/test_torch_transformer_sp.py at dp=1 x sp=2, float64): the
    diagonal step unmasked, the merge dropped and the dk/dv accumulators
    kept away from home each move the parameters far past
    LM_NUM_UPDATE_TOL; a clean run after them equals the one before."""
    import torch_sp_cases as cases
    from mxnet_tpu import transformer as jtr
    from mxnet_tpu_torch import dist

    cfg = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64)
    p0 = jtr.TransformerTrainStep(
        jtr.TransformerConfig(**cfg, dtype="float64",
                              param_dtype="float64"), seed=0).params_numpy()
    spec = dict(cfg=cfg, mesh=(1, 2), p0=p0, steps=2,
                iter=dict(batch_size=4, seq_len=16, vocab_size=64,
                          num_sequences=32),
                step=dict(learning_rate=0.05, bucket_bytes=4096))
    ranks = dist.launch(cases.ring_fault_cases, 2, (spec,), device="cpu",
                        threads=1, timeout_s=300)
    for got in ranks:
        for k, v in got.items():
            assert "error" not in v, v
        clean = got[None]
        assert all(np.array_equal(clean[k], got["after"][k]) for k in clean)
        for f in cs.RING_FAULTS:
            assert cs._update_err(got[f], clean, p0) > \
                1e2 * cs.LM_NUM_UPDATE_TOL, f


def test_the_sp_attention_check_holds_ring_and_ulysses_and_reads_each_fault():
    """train_lm_sp's attention check (``_sp_attention_check``) on two
    gloo CPU ranks, float32 at a cut shape: ring and Ulysses within
    float32 round-off of the plain versions on the full sequence, and
    each planted ring fault read above the check's limits on some
    rank."""
    import torch_sp_cases as cases
    from mxnet_tpu_torch import dist

    spec = dict(cfg=dict(vocab_size=64, n_layers=1, d_model=32, n_heads=4,
                         d_ff=64), batch=2, seq=32, sp=2)
    ranks = dist.launch(cases.sp_attention_check_cases, 2, (spec,),
                        device="cpu", threads=1, timeout_s=300)
    limits = (cs.SP_ATTN_FWD_RTOL, cs.BWD_HEAD_RTOL[torch.bfloat16],
              cs.BWD_AUTOGRAD_RTOL[torch.bfloat16])

    def worst(a):
        return (a["o"], max(a["grads_from_its_output"].values()),
                max(a["grads_float32"].values()))

    for got in ranks:
        for k, v in got.items():
            assert "error" not in v, v
        for impl in ("ring", "ulysses"):
            assert got[impl]["finite"]
            assert max(worst(got[impl])) <= 1e-5, (impl, got[impl])
    for f in cs.RING_FAULTS:
        assert any(e > lim for got in ranks
                   for e, lim in zip(worst(got[f]), limits)), f


# ---------------------------------------------------------------------------
# sparse storage and the recommender tier
# ---------------------------------------------------------------------------
def test_the_sparse_phases_follow_dist_and_report_launches():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_dist_numerics()",
                                     "phase_sparse()",
                                     "phase_recommender()",
                                     "phase_recommender_numerics()",
                                     '"phase": "kernels"')]
    assert order == sorted(order)
    assert main.count("for k, v in sparse_counts.items()") == 4


def test_the_libsvm_writer_reads_back_at_the_phase_shape(tmp_path):
    """write_libsvm's rows carry nnz[0]..nnz[1] distinct sorted ids
    within the feature count and 0/1 labels, the same file for the same
    seed; LibSVMIter reads it into CSR batches, the last one padded."""
    import mxnet_tpu_torch as mx

    a, b = tmp_path / "a.libsvm", tmp_path / "b.libsvm"
    n = cs.write_libsvm(str(a), 300, 2 ** 20, (8, 56), 5)
    assert cs.write_libsvm(str(b), 300, 2 ** 20, (8, 56), 5) == n
    assert a.read_bytes() == b.read_bytes()
    it = mx.io.LibSVMIter(data_libsvm=str(a), data_shape=(2 ** 20,),
                          batch_size=128)
    batches = list(it)
    assert len(batches) == 3 and batches[-1].pad == 84
    assert it._n == 300 and it._data[0].size == n
    for bt in batches:
        counts = np.diff(bt.data[0].indptr.asnumpy())
        assert counts.min() >= 8 and counts.max() <= 56
        cols = bt.data[0].indices.asnumpy()
        assert cols.min() >= 0 and cols.max() < 2 ** 20
        assert set(np.unique(bt.label[0].asnumpy())) <= {0.0, 1.0}


def test_sparse_bounds_count_the_bytes_the_data_needs():
    # dot(csr, W): 16 stored elements, 10 touched rows of W, 4 rows out
    ms, by = cs.csr_dot_bound(16, 4, 8, 10, 2 ** 20, False)
    want = (16 * 12 + 5 * 8 + 10 * 8 * 4 + 4 * 8 * 4) / cs.PEAK_BYTES_S
    assert by == "bytes" and ms == pytest.approx(want * 1e3)
    # dot(csr.T, G) writes the whole (features, dim) output
    ms_t, _ = cs.csr_dot_bound(16, 4, 8, 10, 2 ** 20, True)
    assert ms_t == pytest.approx((16 * 12 + 5 * 8 + 4 * 8 * 4
                                  + 2 ** 20 * 8 * 4) / cs.PEAK_BYTES_S * 1e3)
    # a lazy update of 100 rows, one state: ids, g, w and m in and out
    ms_l, _ = cs.lazy_update_bound(100, 16, 1)
    assert ms_l == pytest.approx(100 * (8 + 16 * 4 * 5)
                                 / cs.PEAK_BYTES_S * 1e3)


def test_the_ideal_ratio_and_the_push_bytes_formula():
    """The pulled-bytes ratio: row_sparse_pull bytes over the dense
    control's table pulls (its pulls less the head's, which the sparse
    run pulls alike); 8 id bytes on 64 row bytes put it at 1.125x the
    unique-rows ideal.  The push formula: per field and shard, unique
    rows x (row bytes + 8), or rows_wire_nbytes under 2-bit."""
    from mxnet_tpu_torch import recommender as rec
    from mxnet_tpu_torch.gradient_compression import GradientCompression

    cfg = rec.RecommenderConfig(n_fields=2, vocab=100, embed_dim=16)
    uniq = 30
    sparse = {"row_sparse_pull": uniq * (16 * 4 + 8), "pull": 500}
    dense = {"pull": 500 + 2 * 100 * 16 * 4}
    ratio, tables = cs.pulled_bytes_ratio(sparse, dense)
    assert tables == 2 * 100 * 16 * 4
    assert ratio / (uniq / (2 * 100)) == pytest.approx(1.125)
    ids = np.array([[0, 99], [0, 50], [49, 50], [3, 99]])
    # shards of 25 rows: field 0 rows {0, 3, 49} -> 2 + 0 + 1 + 0;
    # field 1 rows {50, 99} -> 0 + 0 + 1 + 1
    assert cs._rec_shard_push_bytes(cfg, 4, ids, False) == 5 * 72
    rw = GradientCompression.rows_wire_nbytes
    assert cs._rec_shard_push_bytes(cfg, 4, ids, True) == \
        rw(2, 16) + 3 * rw(1, 16)


def test_sparse_checks_pass_on_the_cpu(tmp_path):
    """The sparse phase's checks on CPU tensors at 4096 features: the
    products within float32 round-off of float64, the lazy updates
    exact on untouched rows, the rsp arithmetic exact, the .params
    round trip bitwise."""
    import mxnet_tpu_torch as mx

    p = tmp_path / "t.libsvm"
    cs.write_libsvm(str(p), 512, 4096, (8, 56), 11)
    batches = list(mx.io.LibSVMIter(data_libsvm=str(p), data_shape=(4096,),
                                    batch_size=128))
    with mx.cpu():
        row = cs.sparse_checks(mx.cpu(), batches, 4096, 16, 11, timed=False)
    assert row["dot_err"] <= cs.SPARSE_RTOL
    assert row["dot_t_err"] <= cs.SPARSE_RTOL
    for name, v in row["lazy"].items():
        assert v["untouched_bitwise"], name
        assert v["weight_err"] <= cs.SPARSE_RTOL, name
        assert v["state_err"] <= cs.SPARSE_RTOL, name
    assert all(row["rsp_ops_exact"].values())
    assert row["params_roundtrip_bitwise"]


def test_the_recommender_numerics_pass_clean_and_read_each_fault():
    """recommender_numerics' local checks with the CPU on both sides:
    lr 0 bitwise, sparse = dense control, and each planted fault (the
    momentum of untouched rows decayed; pushed rows permuted) above
    REC_FAULT_MIN."""
    import mxnet_tpu_torch as mx

    with mx.cpu():
        row = cs.rec_numerics(mx.cpu(), mx.cpu())
    assert row["lr0_bitwise"] and row["sparse_vs_dense_loss_close"]
    assert row["vs_ref_update_err"] == 0.0
    assert row["sparse_vs_dense_update_err"] <= cs.REC_NUM_UPDATE_TOL
    assert row["fault_momentum_decay_update_err"] >= cs.REC_FAULT_MIN
    assert row["fault_permuted_rows_update_err"] >= cs.REC_FAULT_MIN
    from mxnet_tpu_torch.recommender import train

    # the permutation undoes itself
    assert train.ShardedEmbeddingTable.push_rows.__name__ == "push_rows"
    assert train.ShardedEmbeddingTable.push_rows.__qualname__ == \
        "ShardedEmbeddingTable.push_rows"


# ---------------------------------------------------------------------------
# the observability tier
# ---------------------------------------------------------------------------
def test_the_observability_phases_follow_the_recommender_phases():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_recommender_numerics()",
                                     "phase_profiler()",
                                     "phase_traceview(lm)",
                                     "phase_ckpt_async()",
                                     '"phase": "kernels"')]
    assert order == sorted(order)
    assert main.count("for k, v in obs_counts.items()") == 4


def _kineto_fixture():
    import json

    with open(REPO / "mxnet_tpu_torch" / "traceview" /
              "fixture_kineto.json") as f:
        return json.load(f)


def test_the_trace_counting_helpers_agree_with_traceview_parse():
    """chip_smoke's own reading of a kineto trace (launches by name and
    device-busy ms a step window) against traceview.parse on the port's
    kineto-shaped fixture."""
    from mxnet_tpu_torch.traceview import parse

    fx = _kineto_fixture()
    wins = cs.trace_windows(fx["trace"])
    summ = parse.attribute(fx["trace"], plan_meta=fx["plan_meta"])
    counts = parse.device_op_counts(fx["trace"])
    assert len(wins) == summ["steps"]["n"] == 2
    names = set().union(*(w["launches"] for w in wins))
    assert names == set(counts)
    for name in names:
        mean = sum(w["launches"].get(name, 0) for w in wins) / len(wins)
        assert mean == counts[name]["count"], name
    busy = sum(v["mean_s"] for v in summ["phases"].values()) * 1e3
    assert [w["busy_ms"] for w in wins] == pytest.approx([busy, busy])
    assert cs._busy_ms(summ) == pytest.approx(busy)
    assert [w["wall_ms"] for w in wins] == pytest.approx([1.0, 1.0])
    flash = cs.flash_launches(wins[0]["launches"])
    assert flash == {"fwd": 0, "bwd": 1, "bwd_dq": 1, "all_wgmma": True}
    nccl = cs.collective_launches(wins[0]["launches"])
    assert sum(nccl.values()) == 4
    assert sum(v["count"] for k, v in counts.items()
               if parse.classify_op(k) == "comm") == 4


def test_flash_launches_see_a_launch_off_the_wgmma_route():
    counts = {"void flash_fwd_wgmma<64>(CUtensorMap)": 12,
              "void flash_fwd_kernel<__nv_bfloat16, 64>(...)": 1,
              "void flash_bwd_dkv_wgmma<64>(...)": 12,
              "void flash_bwd_dq_wgmma<64>(...)": 12}
    got = cs.flash_launches(counts)
    assert got == {"fwd": 13, "bwd": 12, "bwd_dq": 12, "all_wgmma": False}


def test_trace_armed_sets_and_restores_the_tracer_env(monkeypatch):
    import os

    monkeypatch.setenv("MXNET_TRACE_STEPS", "7")
    monkeypatch.delenv("MXNET_TRACE_DIR", raising=False)
    with cs._trace_armed("/nonexistent/tv", 2) as capture:
        assert os.environ["MXNET_TRACE_DIR"] == "/nonexistent/tv"
        assert os.environ["MXNET_TRACE_STEPS"] == "2"
        assert capture.enabled()
    assert "MXNET_TRACE_DIR" not in os.environ
    assert os.environ["MXNET_TRACE_STEPS"] == "7"


# ---------------------------------------------------------------------------
# the recurrent tier and the phase timings
# ---------------------------------------------------------------------------
def test_the_rnn_phases_follow_tuning_and_precede_the_kernel_line():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_tuning()", "phase_rnn()",
                                     "phase_rnn_numerics()",
                                     '"phase": "phase_seconds"',
                                     '"phase": "kernels"')]
    assert order == sorted(order)
    # every kernel's launches_by_path reads both recurrent phases
    assert main.count("for k, v in rnn_counts.items()") == 4


def test_every_phase_is_timed():
    phases = [n for n in dir(cs) if n.startswith("phase_")]
    assert {"phase_rnn", "phase_rnn_numerics", "phase_device"} <= set(phases)
    for name in phases:
        assert hasattr(getattr(cs, name), "__wrapped__"), name

    def phase_demo():
        return 3

    assert cs._timed(phase_demo)() == 3
    assert cs.PHASE_S.pop("demo") >= 0.0


def test_the_rnn_corpus_fills_every_bucket():
    import random

    import mxnet_tpu_torch as mx

    buckets = list(cs.RNN_LM["buckets"])
    sents = cs.rnn_corpus(32, seed=3)
    assert len(sents) == 32 * len(buckets)
    words = np.concatenate([np.asarray(s) for s in sents])
    assert words.min() >= 1 and words.max() < cs.RNN_LM["vocab"]
    random.seed(0)
    np.random.seed(0)
    it = mx.rnn.BucketSentenceIter(sents, 32, buckets=buckets,
                                   invalid_label=0)
    assert sorted(b.bucket_key for b in it) == buckets


@pytest.mark.parametrize("fused", [False, True])
def test_the_rnn_lm_symbol_has_config_3s_widths(fused):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.rnn import rnn_param_size

    sym, data, label = cs.rnn_lm_sym_gen(mx, fused)(60)
    assert data == ("data",) and label == ("softmax_label",)
    args, outs, _ = sym.infer_shape(data=(32, 60), softmax_label=(32, 60))
    shapes = dict(zip(sym.list_arguments(), args))
    assert shapes["embed_weight"] == (10000, 200)
    assert shapes["pred_weight"] == (10000, 200)
    assert outs == [(32 * 60, 10000)]
    if fused:
        assert shapes["lstm_parameters"] == (rnn_param_size(2, 200, 200),)
    else:
        assert shapes["lstm_l1_h2h_weight"] == (800, 200)


def test_rnn_bucket_fit_repeats_on_the_cpu_and_reads_the_planted_fault():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.module import bucketing_module

    start, end, keys, shares = cs.rnn_bucket_fit(mx.cpu(), True)
    assert sorted(set(keys)) == [4, 6] and len(keys) == 3 and shares
    _, again, keys2, _ = cs.rnn_bucket_fit(mx.cpu(), True)
    assert keys2 == keys
    assert cs._bucket_err(again, end, start) == (0.0, 0.0)
    bucketing_module.FAULTS.add("bucket_own_params")
    try:
        _, faulty, _, shares = cs.rnn_bucket_fit(mx.cpu(), True)
    finally:
        bucketing_module.FAULTS.discard("bucket_own_params")
    assert not shares
    assert cs._bucket_err(faulty, end, start)[0] > cs.RNN_FAULT_MIN


def test_side_by_side_returns_in_order_and_raises():
    import threading

    seen = set()

    def job(i):
        seen.add(threading.get_ident())
        time.sleep(0.05)
        return i

    assert cs.side_by_side(*[lambda i=i: job(i) for i in range(3)]) == \
        [0, 1, 2]
    assert len(seen) == 3

    def bad():
        raise ValueError("planted")

    with pytest.raises(ValueError, match="planted"):
        cs.side_by_side(lambda: 1, bad)


# ---------------------------------------------------------------------------
# the detection tier
# ---------------------------------------------------------------------------
def test_the_ssd_phases_follow_the_rnn_phases_and_precede_the_kernel_line():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_rnn_numerics()", "phase_ssd()",
                                     "phase_ssd_numerics()",
                                     '"phase": "phase_seconds"',
                                     '"phase": "kernels"')]
    assert order == sorted(order)
    # every kernel's launches_by_path reads both detection phases
    assert main.count("for k, v in det_counts.items()") == 4
    assert {"phase_ssd", "phase_ssd_numerics"} <= {
        n for n in dir(cs) if n.startswith("phase_")}


def test_the_nms_kernel_entry_carries_every_shape():
    # the kernels line's box_nms entry: the detection's (32, 400), the
    # full (32, 6132) and the RPN's (2, 6000) rows, each with its kernel
    # ms, device ms, plain ms, bound and mismatches; the routes the main
    # path took
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    entry = main[main.index('"name": "box_nms"'):]
    for key in ('"full_size"', '"rpn"', '"calls_by_route"', '"graph_ms"'):
        assert key in entry
    assert {"ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "mismatches", "shape"} <= set(cs.NMS_ROW_KEYS)
    num = src[src.index("def phase_ssd_numerics"):]
    num = num[:num.index("\ndef ")]
    assert "rpn_nms_inputs()" in num and '"box_nms_rpn"' in num


def test_nms_sorted_rows_are_box_nms_inputs_in_score_order():
    rows = torch.tensor(cs.nms_rows(2, 30)(np.random.RandomState(4)))
    boxes, valid, ids, thresh = cs._nms_sorted(
        rows, dict(overlap_thresh=0.45, topk=20))
    assert tuple(boxes.shape) == (2, 20, 4) and thresh == 0.45
    order = torch.sort(-torch.where(rows[..., 1] > 0, rows[..., 1],
                                    torch.tensor(-np.inf, dtype=rows.dtype)),
                       dim=1, stable=True)[1][:, :20]
    assert torch.equal(ids, torch.gather(rows[..., 0], 1, order))
    assert torch.equal(valid, torch.gather(rows[..., 1] > 0, 1, order))
    assert torch.equal(boxes[..., 0], torch.gather(rows[..., 2], 1, order))


def test_the_ids_fault_passes_the_rest_of_the_library_through():
    class Lib:
        def mxt_box_nms_scratch_bytes(self, *args):
            return 123

    assert cs._IdsDropped(Lib()).mxt_box_nms_scratch_bytes(0, 2, 3) == 123


def test_nms_bound_counts_the_pairs_among_valid_boxes():
    # 2 images of 400 rows, float32: image 0 has 400 valid boxes in two
    # classes (300 and 100), image 1 three of one class.  12 operations
    # for each pair of one class and a compare of ids for each pair of
    # valid boxes, over 67 TFLOP/s, against 400 * 22 bytes an image over
    # 3.35 TB/s
    ms, by = cs.nms_bound([[300, 100], [3]], 400, 4)
    ops = 12 * (300 * 299 // 2 + 100 * 99 // 2 + 3) + 400 * 399 // 2 + 3
    assert by == "operations"
    assert ms == pytest.approx(ops / 67e12 * 1e3)
    ms, by = cs.nms_bound([[1], [1]], 1000, 8)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 1000 * 42 / 3.35e12 * 1e3)


def test_nms_class_counts_read_each_images_valid_boxes_by_class():
    valid = torch.tensor([[True, True, False, True], [False] * 4])
    ids = torch.tensor([[2.0, 0.0, 2.0, 2.0], [1.0] * 4])
    assert cs.nms_class_counts(valid, ids) == [[1, 2], []]
    ms, _ = cs.nms_bound(cs.nms_class_counts(valid, ids), 4, 8)
    assert ms > 0


def test_det_labels_come_out_of_the_iterators_rows():
    # [c, h, w, len, header width 2, object width 6, objects...], padded
    row = [3, 512, 512, 14, 2, 6, 4, .1, .2, .3, .4, 0,
           7, .5, .5, .9, .8, 0] + [-1.0] * 6
    out = cs.det_labels_from_batch(np.array([row, row]), max_objects=3)
    assert out.shape == (2, 3, 5)
    np.testing.assert_allclose(out[0, :2], [[4, .1, .2, .3, .4],
                                            [7, .5, .5, .9, .8]], rtol=1e-6)
    assert (out[:, 2] == -1).all()


def test_the_examples_bars():
    good = [(5.0, 0.04), (2.0, 0.07), (1.5, 0.1), (1.0, 0.12)]
    assert all(cs.example_bars(good).values())
    bad = cs.example_bars([(5.0, 0.2), (4.0, 0.1), (3.5, 0.1), (3.2, 0.1)])
    assert bad == {"loss_falls": False, "map_above_0.05": True,
                   "map_holds": False}


@pytest.mark.parametrize("case", cs.DET_CASES[:6] + cs.DET_CASES[8:12],
                         ids=cs.det_case_id)
def test_det_cases_agree_with_themselves_on_the_cpu(case):
    # the card-vs-CPU check's plumbing: a rerun reads 0, and the planted
    # faults touch CUDA tensors only
    ins, rng = cs.det_case_inputs(case)
    a, ga = cs.run_det_case(case, "cpu", ins, np.random.RandomState(1))
    with cs.planted_det_fault(*cs.DET_FAULTS):
        b, gb = cs.run_det_case(case, "cpu", ins, np.random.RandomState(1))
    assert [cs.det_case_err(x, y, case, k)
            for k, (x, y) in enumerate(zip(b, a))] == [0.0] * len(a)
    assert len(ga) == len(gb) == len(case.diff)


def test_planted_det_faults_are_taken_out_after_the_check():
    # the faults live in the smoke: the ops module is left as it was,
    # and the NMS fault withholds the ids from the kernel's library
    from mxnet_tpu_torch.ops import contrib, registry

    before = (registry.get("MultiBoxPrior").fn, contrib._nms_lib,
              contrib._encode_box)
    calls = []

    class Lib:
        def mxt_box_nms_keep(self, *args):
            calls.append(args)
            return 0

    with cs.planted_det_fault(*cs.DET_FAULTS):
        assert registry.get("_contrib_MultiBoxPrior").fn is not before[0]
        assert contrib._encode_box is not before[2]
        assert cs._IdsDropped(Lib()).mxt_box_nms_keep(0, 1, 2, 3) == 0
    assert calls == [(0, 1, None, 3)]
    assert (registry.get("MultiBoxPrior").fn, contrib._nms_lib,
            contrib._encode_box) == before
    assert not hasattr(contrib, "FAULTS")


def test_det_case_err_reads_a_flipped_keep_and_a_moved_value():
    case = cs.DetCase("box_nms", [], {}, exact=((0, 0),))
    want = np.array([[[0, 0.9, 0, 0, 1, 1], [-1, -1, -1, -1, -1, -1]]])
    got = want.copy()
    got[0, 1, 0] = 1
    assert cs.det_case_err(got, want, case, 0) == float("inf")
    got = want.copy()
    got[0, 0, 3] += 1e-9
    assert cs.det_case_err(got, want, case, 0) == pytest.approx(1e-9)
    exact = cs.DetCase("quantize", [], {}, exact=(0,))
    assert cs.det_case_err(np.array([1, 2, 3]), np.array([1, 2, 4]),
                           exact, 0) == 1.0


def test_the_full_size_nms_rows_follow_the_ssd512_layout():
    rows = cs._nms_full_rows()
    assert tuple(rows.shape) == (32, cs.SSD_ANCHORS, 6)
    assert rows.dtype == torch.float64
    valid = rows[..., 0] >= 0
    assert valid.float().mean() > 0.5   # scores above 0.01 mostly
    assert ((rows[..., 2:] >= 0) & (rows[..., 2:] <= 1)).all()
