"""The SSD programs of ``chip_smoke.py`` against the JAX package on the
CPU: the example's ``SSDNet`` (``examples/ssd/train_ssd.py``) and a
narrow ``ssd_net`` (ResNet-18's layout at narrow widths, 128², batch 2,
the six heads of the SSD-512 layout) built in both packages with the
weights carried across, in float64: the outputs, the loss
(``ssd_loss`` against the example's), every gradient, one SGD
``Trainer`` step and the ``MultiBoxDetection`` rows.  The port's
``VOC07MApMetric`` / ``MApMetric`` against the example's on
``tests/test_ssd_e2e.py``'s hand-computed case; one step of
``examples/rcnn/mini_rcnn.py``'s network in both packages.

Tolerance: 1e-10 of each value's largest magnitude (at least 1): float64
convolutions and BatchNorm sum in another order in XLA and ATen.  The
detections' class column (which rows NMS kept) must be equal.
"""
import contextlib
import os
import sys

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

import chip_smoke as cs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples", "ssd"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples", "rcnn"))

TOL = 1e-10
NARROW = dict(cs.SSD_LAYOUT, num_filters=(32, 16, 16, 8))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * scale, (what, err, scale)


def _carry(jnet, tnet):
    """The JAX net's parameters into the port's, in registration order
    (both built by the same code)."""
    jps = list(jnet.collect_params().values())
    tps = list(tnet.collect_params().values())
    assert len(jps) == len(tps)
    for j, t in zip(jps, tps):
        a = j.data().asnumpy()
        assert tuple(t.shape) == a.shape, (j.name, t.name)
        t.set_data(tmx.nd.array(a, dtype=str(a.dtype), ctx=tmx.cpu()))
    return jps, tps


def _twins(build, x_shape, seed=0):
    """(jax net, port net) from ``build(pkg)``, initialised in JAX,
    float64, the port's on the CPU with the JAX weights."""
    np.random.seed(seed)
    jmx.random.seed(seed)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros(x_shape))
    jnet.cast("float64")
    tnet = build(tmx)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    with tmx.cpu():
        tnet(tmx.nd.zeros(x_shape))
    tnet.cast("float64")
    _carry(jnet, tnet)
    return jnet, tnet


def _labels(B, O=3, seed=1, classes=3):
    rng = np.random.RandomState(seed)
    lab = np.full((B, O, 5), -1.0)
    for b in range(B):
        for o in range(rng.randint(1, O + 1)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.2, 0.4, 2)
            lab[b, o] = [rng.randint(0, classes), x0, y0, x0 + w, y0 + h]
    return lab


def _step_both(jnet, tnet, jfwd, tfwd, x, lab, lr=0.05):
    """One recorded forward + backward + SGD step in each package:
    (outputs, loss, grads, params after) a package."""
    res = []
    for pkg, net, fwd in ((jmx, jnet, jfwd), (tmx, tnet, tfwd)):
        with (tmx.cpu() if pkg is tmx else contextlib.nullcontext()):
            xs = pkg.nd.array(x, dtype="float64")
            ys = pkg.nd.array(lab, dtype="float64")
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": lr,
                                         "momentum": 0.9, "wd": 5e-4})
            with pkg.autograd.record():
                outs, loss = fwd(pkg, net, xs, ys)
            loss.backward()
            grads = [p.grad().asnumpy()
                     for p in net.collect_params().values()
                     if p.grad_req != "null"]
            trainer.step(1)
            after = [p.data().asnumpy()
                     for p in net.collect_params().values()]
            res.append(([o.asnumpy() for o in outs], float(loss.asnumpy()),
                         grads, after))
    return res


def _compare(res):
    (jo, jl, jg, ja), (to, tl, tg, ta) = res
    for k, (t, j) in enumerate(zip(to, jo)):
        _close(t, j, "output %d" % k)
    _close(tl, jl, "loss")
    assert len(tg) == len(jg)
    for k, (t, j) in enumerate(zip(tg, jg)):
        _close(t, j, "gradient %d" % k)
    for k, (t, j) in enumerate(zip(ta, ja)):
        _close(t, j, "parameter %d after the step" % k)


def _detections(pkg, cls, loc, anchors, **kw):
    nd = pkg.nd
    return nd.contrib.MultiBoxDetection(nd.softmax(cls, axis=1), loc,
                                        anchors, **kw).asnumpy()


def test_example_ssdnet_loss_gradients_and_step_match_jax():
    import train_ssd

    size = 40
    jnet, tnet = _twins(
        lambda pkg: train_ssd.SSDNet(3, 2) if pkg is jmx
        else cs.example_ssd_net(tmx, 3, 2), (1, 1, size, size))
    ja = cs.example_anchors(jmx.nd, jnet, size)
    with tmx.cpu():
        ta = cs.example_anchors(tmx.nd, tnet, size)
    _close(ta.asnumpy(), ja.asnumpy(), "anchors")
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 1, (4, 1, size, size))
    lab = _labels(4)

    def jfwd(pkg, net, xs, ys):
        cls, loc = net(xs)
        return (cls, loc), train_ssd.ssd_loss(cls, loc, ja, ys)

    def tfwd(pkg, net, xs, ys):
        cls, loc = net(xs)
        return (cls, loc), cs.ssd_loss(tmx.nd, cls, loc, ta, ys)

    res = _step_both(jnet, tnet, jfwd, tfwd, x, lab)
    _compare(res)
    # detections of the stepped nets
    xs = x[:2]
    jc, jl = jnet(jmx.nd.array(xs, dtype="float64"))
    with tmx.cpu():
        tc, tl = tnet(tmx.nd.array(xs, dtype="float64"))
    kw = dict(threshold=0.25, nms_threshold=0.45)
    jd = _detections(jmx, jc, jl, ja, **kw)
    with tmx.cpu():
        td = _detections(tmx, tc, tl, ta, **kw)
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    _close(td, jd, "detections")


def _narrow_backbone(pkg):
    res = jresnet if pkg is jmx else tresnet
    return res.ResNetV1(res.BasicBlockV1, [2, 2, 2, 2], [8, 8, 16, 32, 64],
                        classes=10)


def test_narrow_ssd_net_matches_jax_with_all_six_heads():
    size = 128
    jnet, tnet = _twins(
        lambda pkg: cs.ssd_net(pkg, _narrow_backbone(pkg), NARROW,
                               classes=20), (1, 3, size, size))
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 3, size, size))
    lab = _labels(2, classes=20)

    def fwd(pkg, net, xs, ys):
        cls, loc, anchors = net(xs)
        return (cls, loc, anchors), cs.ssd_loss(
            pkg.nd, cls, loc, anchors, ys, mining_thresh=0.5)

    res = _step_both(jnet, tnet, fwd, fwd, x, lab, lr=0.004)
    # six maps: 8, 4, 2, 1, 1, 1 at 128² -> 390 anchors
    assert res[1][0][2].shape == (1, 390, 4)
    assert res[1][0][0].shape == (2, 21, 390)
    _compare(res)
    xs = x[:2]
    with jmx.autograd.pause():
        jc, jl, ja = jnet(jmx.nd.array(xs, dtype="float64"))
    with tmx.cpu():
        tc, tl, ta = tnet(tmx.nd.array(xs, dtype="float64"))
        td = _detections(tmx, tc, tl, ta, **cs.SSD["detection"])
    jd = _detections(jmx, jc, jl, ja, **cs.SSD["detection"])
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    _close(td, jd, "detections")


def fresh_target_trajectories(steps=10, lr=0.004, seed=3):
    """The narrow ``ssd_net``'s loss on one fixed batch over ``steps``
    SGD steps from the same weights in each package, its targets (the
    matching and the mined negatives) taken anew at every step from that
    step's predictions: (JAX losses, port losses)."""
    size = 128
    jnet, tnet = _twins(
        lambda pkg: cs.ssd_net(pkg, _narrow_backbone(pkg), NARROW,
                               classes=20), (1, 3, size, size))
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (2, 3, size, size))
    lab = _labels(2, classes=20)
    out = []
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        with (tmx.cpu() if pkg is tmx else contextlib.nullcontext()):
            xs = pkg.nd.array(x, dtype="float64")
            ys = pkg.nd.array(lab, dtype="float64")
            trainer = pkg.gluon.Trainer(
                net.collect_params(), "sgd",
                {"learning_rate": lr, "momentum": 0.9, "wd": 5e-4})
            losses = []
            for _ in range(steps):
                with pkg.autograd.record():
                    cls, loc, anchors = net(xs)
                    loss = cs.ssd_loss(pkg.nd, cls, loc, anchors, ys,
                                       mining_thresh=0.5)
                loss.backward()
                trainer.step(1)
                losses.append(float(loss.asnumpy()))
        out.append(losses)
    return out


def test_narrow_ssd_net_fresh_target_trajectory_matches_jax():
    # ten steps at config 4's lr with the targets taken anew each step
    # (so MultiBoxTarget's matching and mining run in every step): the
    # port's losses follow the JAX package's, whichever way they go
    jl, tl = fresh_target_trajectories()
    assert len(jl) == len(tl) == 10
    for k, (t, j) in enumerate(zip(tl, jl)):
        _close(t, j, "loss at step %d" % k)


def test_the_ssd512_layout_has_6132_anchors_and_the_config_4_widths():
    with tmx.cpu():
        net = cs.ssd_net(tmx, tmx.gluon.model_zoo.vision.resnet50_v1())
    per_cell = [len(s) + len(r) - 1 for s, r in zip(cs.SSD_LAYOUT["sizes"],
                                                     cs.SSD_LAYOUT["ratios"])]
    assert per_cell == [4, 6, 6, 6, 4, 4]
    assert sum(a * m * m for a, m in zip(per_cell, (32, 16, 8, 4, 2, 1))) \
        == cs.SSD_ANCHORS == 6132
    heads = [h._channels for h in net.cls_heads]
    assert heads == [a * 21 for a in per_cell]
    assert [h._channels for h in net.loc_heads] == [a * 4 for a in per_cell]
    extras = [[c._channels for c in blk if hasattr(c, "_channels")]
              for blk in net.extras]
    assert extras == [[256, 512], [128, 256], [128, 256], [128, 128]]
    assert all(p.grad_req == "null"
               for p in net.backbone.output.collect_params().values())


def test_the_ports_map_metrics_equal_the_examples():
    from eval_metric import MApMetric, VOC07MApMetric

    label = np.array([[[0, 0.0, 0.0, 0.2, 0.2], [0, 0.5, 0.5, 0.8, 0.8],
                       [-1, 0, 0, 0, 0]]], np.float32)
    det = np.array([[[0, 0.9, 0.0, 0.0, 0.2, 0.2],
                     [0, 0.6, 0.3, 0.3, 0.4, 0.4],
                     [0, 0.3, 0.5, 0.5, 0.8, 0.8]]], np.float32)
    label2 = np.array([[[1, 0.1, 0.1, 0.3, 0.3], [-1, 0, 0, 0, 0],
                        [-1, 0, 0, 0, 0]]], np.float32)
    det2 = np.zeros((1, 0, 6), np.float32)
    TM, TV = cs.map_metrics()
    for ours, theirs, want in ((TM, MApMetric, 0.5 + 0.5 * (2.0 / 3.0)),
                               (TV, VOC07MApMetric,
                                (6 * 1.0 + 5 * (2.0 / 3.0)) / 11.0)):
        a, b = ours(iou_thresh=0.5), theirs(iou_thresh=0.5)
        a.update([label], [det])
        b.update([label], [det])
        assert a.get()[1] == b.get()[1]
        np.testing.assert_allclose(a.get()[1], want, rtol=1e-6)
        with tmx.cpu():
            a.update([tmx.nd.array(label2)], [tmx.nd.array(det2)])
        b.update([label2], [det2])
        assert a.get() == b.get()
    assert TV(iou_thresh=0.5).get()[0] == "VOC07mAP"


def test_records_parse_back_into_detection_labels(tmp_path):
    path = str(tmp_path / "d.rec")
    cs.write_ssd_records(path, 6, seed=4, size=48)
    with tmx.cpu():
        it = tmx.io.ImageDetRecordIter(path_imgrec=path, batch_size=3,
                                       data_shape=(3, 64, 64),
                                       resize_mode="force")
        batches = [b.label[0].asnumpy() for b in it]
    labs = np.concatenate([cs.det_labels_from_batch(b) for b in batches])
    assert labs.shape == (6, cs.SSD["max_objects"], 5)
    n_obj = (labs[..., 0] >= 0).sum(1)
    assert ((n_obj >= 1) & (n_obj <= 3)).all()
    real = labs[labs[..., 0] >= 0]
    assert (real[:, 0] < cs.SSD["classes"]).all()
    assert ((real[:, 1:] >= 0) & (real[:, 1:] <= 1)).all()
    assert (real[:, 3] > real[:, 1]).all() and (real[:, 4] > real[:, 2]).all()


def test_mini_rcnn_step_matches_the_examples_network():
    import mini_rcnn

    np.random.seed(0)
    jmx.random.seed(0)
    jnet = mini_rcnn.MiniRCNN()
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((2, 3, 64, 64)))
    jnet.cast("float64")
    tnet = cs.mini_rcnn_net(tmx)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    with tmx.cpu():
        tnet(tmx.nd.zeros((2, 3, 64, 64)))
    tnet.cast("float64")
    _carry(jnet, tnet)
    rng = np.random.RandomState(0)
    imgs, _, cls = cs.mini_rcnn_batch(rng, 4)
    outs = []
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        with (tmx.cpu() if pkg is tmx else contextlib.nullcontext()):
            x = pkg.nd.array(imgs, dtype="float64")
            with pkg.autograd.record():
                score, delta, rois, logits = net(x)
                loss = (-(pkg.nd.log_softmax(score.reshape((4, 2, -1)),
                                             axis=1)[:, 1, :]).mean()
                        + (logits ** 2).mean() + (delta ** 2).mean())
            loss.backward()
            outs.append((rois.asnumpy(), float(loss.asnumpy()),
                         [p.grad().asnumpy()
                          for p in net.collect_params().values()]))
    (jr, jl, jg), (tr, tl, tg) = outs
    _close(tr, jr, "rois")
    _close(tl, jl, "loss")
    for k, (t, j) in enumerate(zip(tg, jg)):
        _close(t, j, "gradient %d" % k)
