"""The host-side helpers of ``chip_smoke.py``, on the CPU: the parsing
of ``cuobjdump -sass`` and ``-res-usage`` output that the ``build``
phase checks the wgmma kernels with, the rtc add's grid, the row-scaled
error the flash rows are held to, and the attention bound; for the
transformer phases, the head-scaled error of the backward rows, the
backward's bound, the step's FLOP count and the profile's kernel groups.
The script itself needs a card and refuses to run without one."""
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


BWD_MMA = ("_ZN50_GLOBAL__N__4bd607fe_17_flash_attn_bwd_cu_3b68708a2tc17"
           "flash_bwd_dkv_mmaILi128EEEvPKtS3_S3_S3_PKfS5_P13__nv_bfloat16"
           "S7_iiiiNS_7StridesEfi")
BWD_SIMT = ("_ZN50_GLOBAL__N__4bd607fe_17_flash_attn_bwd_cu_3b68708a12"
            "flash_bwd_dqI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_S4_PKfPfPS2_"
            "iiiiiiNS_7StridesEfi")


def test_backward_kernel_labels():
    assert cs._kernel_label(BWD_MMA) == "flash_bwd_dkv_mma<128>"
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
    assert cs.lm_kernel_group(BWD_MMA) == "attention_bwd"
    assert cs.lm_kernel_group(
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>"
    ) == "gemm_f32_head"
    assert cs.lm_kernel_group("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"
                              ) == "gemm_bf16"
    assert cs.lm_kernel_group("flash_fwd_wgmma<64>") == "attention_fwd"
