"""CLI: ``python -m mxnet_tpu_torch.analysis --self-test`` (every seeded
fixture flagged, the clean step passed) / ``--demo-audit`` (audit a
small FusedTrainStep built in-process).

Counterpart: ``mxnet_tpu/analysis/__main__.py``.
"""
from __future__ import annotations

import argparse
import sys


def _self_test(args) -> int:
    """Every seeded fixture violation must be flagged by its check and
    the clean step must pass all of them — the auditor's own
    contract."""
    from . import auditor, fixtures

    failures = []

    def expect(label, findings, check):
        hits = [f for f in findings if f.check == check]
        if not hits:
            failures.append("%s: %s NOT flagged" % (label, check))
        return hits

    with fixtures.one_rank_group():
        # 1. rank-dependent collective order
        expect("rank_dependent", auditor.check_collective_uniformity(
            fixtures.rank_dependent_traces(), "fixture.rank_dependent"),
            "collective-uniformity")

        # 2. a replaced 4 MiB parameter (and its in-place twin is clean)
        fn, specs = fixtures.undonated_step()
        bad, _ = auditor.audit_step(fn, specs, site="fixture.undonated")
        hits = expect("undonated", bad, "donation")
        if hits and hits[0].details["wasted_bytes"] < \
                fixtures.UNDONATED_BYTES:
            failures.append("undonated: reported %d bytes < planted"
                            % hits[0].details["wasted_bytes"])
        fn, specs = fixtures.donated_step()
        good, _ = auditor.audit_step(fn, specs, site="fixture.donated")
        if good:
            failures.append("in-place twin still flagged: %r" % good)

        # 3. bf16 -> f32 silent upcast
        expect("upcast", auditor.check_dtype(
            fixtures.upcast_log(), "fixture.upcast", "bfloat16"), "dtype")

        # 4. a value read back inside the step
        expect("host_sync", auditor.check_host_sync(
            fixtures.host_sync_log(), "fixture.host_sync"), "host-sync")

        # 5. the clean step passes everything
        fn, specs = fixtures.clean_step()
        findings, meta = auditor.audit_step(
            fn, specs, site="fixture.clean", compute_dtype="bfloat16")
        if findings:
            failures.append("clean step flagged: %s"
                            % [f.to_dict() for f in findings])
        if meta.get("n_collectives", 0) < 1:
            failures.append("clean step signature missed its all-reduce")

    # 6. remat effectiveness: the declared-but-inert policy is flagged;
    # the per-stage plan enters regions AND lowers the live peak
    expect("noop_remat", auditor.check_remat_effectiveness(
        fixtures.noop_remat_log(), "fixture.noop_remat", "stage"),
        "remat-effectiveness")
    remat_log, twin_log = fixtures.remat_twin_logs()
    if auditor.count_remat_eqns(remat_log) < 3:
        failures.append("remat twin: expected >= 3 regions, got %d"
                        % auditor.count_remat_eqns(remat_log))
    peak, twin_peak = (auditor.peak_live_bytes(remat_log),
                       auditor.peak_live_bytes(twin_log))
    if not peak < twin_peak:
        failures.append("remat twin: peak live bytes did not drop "
                        "(%d >= %d)" % (peak, twin_peak))
    if auditor.check_remat_effectiveness(
            remat_log, "fixture.remat_twin", "stage", twin_log=twin_log):
        failures.append("effective remat plan wrongly flagged")

    # 7. decode-bucket discipline
    plan, observed, counts = fixtures.decode_bucket_violation()
    hits = expect("decode_buckets", auditor.check_decode_buckets(
        plan, observed, "fixture.decode_buckets",
        compile_counts=counts), "decode-buckets")
    planted = {f.details.get("fingerprint_key", "").split(":")[0]
               for f in hits}
    if not {"shape", "total"} <= planted:
        failures.append("decode_buckets: expected both the rogue-shape"
                        " and excess-compile findings, got %s"
                        % sorted(planted))
    cplan, cobs, ccounts = fixtures.decode_bucket_clean()
    if auditor.check_decode_buckets(cplan, cobs,
                                    "fixture.decode_buckets_clean",
                                    compile_counts=ccounts):
        failures.append("clean decode-bucket twin wrongly flagged")

    # 8. sparse gradients: the whole-table gather is flagged at its
    # vocab; the pulled-rows twin passes at the same vocab
    hits = expect("sparse_gradients", auditor.check_sparse_gradients(
        fixtures.sparse_gradient_violation(), "fixture.sparse_grad",
        fixtures.SPARSE_FIXTURE_VOCAB,
        embed_dim=fixtures.SPARSE_FIXTURE_DIM), "sparse-gradients")
    if hits and hits[0].details["n_dense_scatters"] < 1:
        failures.append("sparse_gradients: flagged without a scatter")
    if auditor.check_sparse_gradients(
            fixtures.sparse_gradient_clean(), "fixture.sparse_grad_clean",
            fixtures.SPARSE_FIXTURE_VOCAB,
            embed_dim=fixtures.SPARSE_FIXTURE_DIM):
        failures.append("clean sparse-gradient twin wrongly flagged")

    if failures:
        print("analysis self-test FAILED:")
        for f in failures:
            print("  -", f)
        return 1
    print("analysis self-test OK: 7 seeded violations flagged, clean "
          "step passed (%d ops, %d collectives), remat twin peak "
          "%d -> %d bytes" % (meta.get("n_eqns", 0),
                              meta.get("n_collectives", 0), twin_peak,
                              peak))
    return 0


def _demo_audit(args) -> int:
    """Build and run a small FusedTrainStep on ``--device``, then audit
    every step it recorded."""
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    from . import auditor

    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    with ctx:
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(10))
        net.initialize(mx.init.Xavier())
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss())
        X = mx.nd.array(np.random.uniform(size=(8, 16)).astype("float32"))
        y = mx.nd.array(np.random.randint(0, 10, 8).astype("float32"))
        step(X, y)
        report = auditor.audit_recorded_steps(
            baseline=auditor.load_baseline(args.baseline))
    print(report.summary())
    if args.json:
        report.write_json(args.json)
        print("findings written to", args.json)
    return 1 if report.n_findings else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis",
        description="step auditor over the op log of a train step")
    ap.add_argument("--self-test", action="store_true",
                    help="verify the auditor flags every seeded "
                         "fixture violation")
    ap.add_argument("--demo-audit", action="store_true",
                    help="build a small FusedTrainStep and audit it")
    ap.add_argument("--device", default="cuda",
                    help="the demo step's device (cuda or cpu)")
    ap.add_argument("--json", help="write the findings JSON here")
    ap.add_argument("--baseline",
                    help="suppressions file (default: the committed "
                         "analysis/baseline.json)")
    args = ap.parse_args(argv)
    if args.self_test:
        return _self_test(args)
    if args.demo_audit:
        return _demo_audit(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
