"""``ops/detection.py`` of the port against the JAX package, and a small
SSD built with ``static.nn`` on both sides.

The ops: every sweep case (``tools/eager_sweep.py``) through both
packages' public wrappers, values, dtypes and gradients exact except
where ``_torch_tail_parity.LOOSE`` states a relative limit (1e-5 for
``roi_align``); the host-side ops' numpy results equal. Beyond the
sweep: NMS tie order (equal scores keep the lower index, as JAX's stable
sort), ``eta`` decay, the batched ``multiclass_nms`` / ``bipartite_match``
equal to the JAX function image by image, and JAX's cases of
``tests/test_detection_ops.py``.

The SSD (two feature maps of a 64 x 64 image, ``multi_box_head`` over
``prior_box``, the reference's loss: ``iou_similarity`` ->
``bipartite_match`` -> ``target_assign`` -> ``box_coder`` encode ->
``mine_hard_examples`` -> smooth-L1 + softmax CE) runs from the same
weights in both packages: the loss within 1e-5 relative, each gradient
within 1e-4 of its largest entry, the NMS rows and the mAP equal.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from _torch_eager_parity import covered, on_cpu, registry_names
from _torch_tail_parity import tail_parity
from paddle_tpu_torch.ops import detection as TD
from paddle_tpu_torch.tools.eager_sweep import detection_cases

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


DET = detection_cases()


@pytest.mark.parametrize("case", DET, ids=[c[0] for c in DET])
def test_detection_op_matches_jax(case):
    if case[0] == "generate_mask_labels":
        pytest.importorskip("PIL")
    tail_parity(case)


def test_every_op_is_covered_and_registered_as_in_jax():
    jnames, tnames = registry_names("detection")
    assert tnames == jnames and covered(DET) | {"yolo_box"} == set(jnames)


def _jd():
    from paddle_tpu.ops import detection as JD
    return JD


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_nms_ties_keep_the_lower_index_and_eta_decays():
    import jax.numpy as jnp
    JD = _jd()
    boxes = np.array([[0, 0, 1, 1], [0, 0, 1, 1.01], [2, 2, 3, 3],
                      [2, 2, 3, 3], [0.1, 0, 1.1, 1]], np.float32)
    scores = np.array([0.5, 0.5, 0.5, 0.9, 0.5], np.float32)
    for kw in ({}, {"eta": 0.8, "iou_threshold": 0.9},
               {"max_out": 2}, {"score_threshold": 0.6}):
        ji, jv = JD.nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
        ti, tv = TD.nms(_t(boxes), _t(scores), **kw)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # equal scores 0.5: the stable order keeps index 0 ahead of 1, so 0
    # survives and its near-duplicate 1 is suppressed
    ti, tv = TD.nms(_t(boxes), _t(scores))
    kept = ti.numpy()[tv.numpy()].tolist()
    assert kept[0] == 3 and 0 in kept and 1 not in kept


def _det_batch(seed, bsz, n, c):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 0.8, (bsz, n, 2))
    wh = r.uniform(0.05, 0.4, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = r.uniform(0, 1, (bsz, c, n)).astype(np.float32)
    scores[:, :, ::7] = 0.5          # planted ties
    return boxes, scores


def test_batched_multiclass_nms_equals_jax_image_by_image():
    JD = _jd()
    boxes, scores = _det_batch(2, 3, 30, 4)
    kw = dict(score_threshold=0.05, nms_top_k=12, keep_top_k=20,
              iou_threshold=0.45, background_label=0)
    out, cnt = TD.multiclass_nms(_t(boxes), _t(scores), **kw)
    import jax.numpy as jnp
    for i in range(3):
        jo, jc = JD.multiclass_nms(jnp.asarray(boxes[i]),
                                   jnp.asarray(scores[i]), **kw)
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(jo))
        assert int(cnt[i]) == int(jc)


def test_batched_bipartite_match_equals_jax_per_matrix():
    import jax.numpy as jnp
    JD = _jd()
    r = np.random.default_rng(4)
    d = r.uniform(0, 1, (3, 4, 9)).astype(np.float32)
    d[0, :, 2] = 0.7                  # ties across a column
    d[2, 3:] = -np.inf                # a shorter matrix padded
    for mt in ("bipartite", "per_prediction"):
        ti, tv = TD.bipartite_match(_t(d), mt, 0.4)
        for i in range(3):
            rows = 3 if i == 2 else 4
            ji, jv = JD.bipartite_match(jnp.asarray(d[i, :rows]), mt, 0.4)
            np.testing.assert_array_equal(ti[i].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))


def test_jax_package_detection_cases():
    """The cases of ``tests/test_detection_ops.py`` the port's ops can
    take: priors, coder round trip, NMS suppression, ROI pooling."""
    JD = _jd()
    pb, pv = TD.prior_box(2, 2, 8, 8, [2.0], max_sizes=[4.0],
                          aspect_ratios=[2.0])
    jb, jv = JD.prior_box(2, 2, 8, 8, [2.0], max_sizes=[4.0],
                          aspect_ratios=[2.0])
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    prior = np.array([[0.1, 0.1, 0.5, 0.5], [0.2, 0.3, 0.6, 0.9]],
                     np.float32)
    tgt = np.array([[0.15, 0.12, 0.45, 0.55]], np.float32)
    enc = TD.box_coder(_t(prior), None, _t(tgt))
    dec = TD.box_coder(_t(prior), None, enc[0], code_type="decode")
    np.testing.assert_allclose(dec.numpy(), np.repeat(tgt, 2, 0),
                               rtol=1e-5, atol=1e-6)
    x = np.arange(2 * 6 * 6, dtype=np.float32).reshape(2, 6, 6)
    rois = np.array([[0, 0, 5, 5], [1, 1, 3, 4]], np.float32)
    np.testing.assert_array_equal(
        TD.roi_pool(_t(x), _t(rois), 2).numpy(),
        np.asarray(JD.roi_pool(x, rois, 2)))


# -- a two-feature-map SSD on both sides --------------------------------------------

IMG, NCLS, BSZ = 64, 4, 2


def _ssd_data():
    r = np.random.default_rng(9)
    img = r.standard_normal((BSZ, 3, IMG, IMG)).astype(np.float32)
    gts, labels = [], []
    for n in (2, 3):
        xy = r.uniform(0, 0.6, (n, 2))
        wh = r.uniform(0.15, 0.4, (n, 2))
        gts.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        labels.append(r.integers(1, NCLS, n).astype(np.int32))
    return img, gts, labels


def ssd_loss(pkg, locs, confs, priors, pvars, gts, labels):
    """The reference's SSD loss on one package's eager API: match by IoU,
    assign, encode, mine 3:1 negatives, smooth-L1 + softmax CE over the
    positives and mined negatives, summed over the batch and divided by
    the positives."""
    n_prior = priors.shape[0]
    total, n_pos = 0.0, 0
    for i, (gt, lab) in enumerate(zip(gts, labels)):
        iou = pkg.iou_similarity(pkg.to_tensor(gt), priors)
        mi, _ = pkg.bipartite_match(iou, "per_prediction", 0.5)
        mi_np = np.asarray(mi.numpy()).reshape(1, -1)
        lab_t, _ = pkg.target_assign(pkg.to_tensor(lab.reshape(-1, 1)),
                                     pkg.to_tensor(mi_np),
                                     mismatch_value=0)
        enc = pkg.box_coder(priors, pvars, pkg.to_tensor(gt))
        safe = np.clip(mi_np[0], 0, len(gt) - 1)
        loc_t = enc[pkg.to_tensor(safe.astype(np.int32)),
                    pkg.to_tensor(np.arange(n_prior, dtype=np.int32))]
        logp = pkg.nn.functional.log_softmax(confs[i], axis=-1)
        lab_np = np.asarray(lab_t.numpy()).reshape(-1).astype(np.int32)
        ce = -pkg.take_along_axis(logp, pkg.to_tensor(
            lab_np.reshape(-1, 1)), 1).reshape([-1])
        _, neg = pkg.mine_hard_examples(
            ce.numpy().reshape(1, -1), mi_np, neg_pos_ratio=3.0)
        pos = mi_np[0] >= 0
        sel = np.zeros(n_prior, np.float32)
        sel[pos] = 1.0
        sel[np.asarray(neg[0], np.int64)] = 1.0
        total = total + (ce * pkg.to_tensor(sel)).sum()
        d = locs[i] - loc_t
        ad = pkg.abs(d)
        sl1 = pkg.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(axis=1)
        total = total + (sl1 * pkg.to_tensor(pos.astype(np.float32))).sum()
        n_pos += int(pos.sum())
    return total / max(n_pos, 1)


def test_small_ssd_matches_jax():
    import paddle_tpu.static as jst
    import paddle_tpu_torch.static as tst
    from paddle_tpu.ops.metric_extra import detection_map as jmap
    from paddle_tpu_torch.ops.metric_extra import detection_map as tmap
    from paddle_tpu_torch.static.nn import load_jax_scope
    img, gts, labels = _ssd_data()
    with jst.scope_guard(jst.Scope()), tst.scope_guard(tst.Scope()):
        jl, jc, jb, jv = jssd = _named_ssd(pt, jst.nn, pt.ParamAttr, img)
        scope = jst.global_scope()
        names = scope.local_var_names()
        load_jax_scope({n: np.asarray(scope.find_var(n).numpy())
                        for n in names})
        tl, tc, tb, tv = _named_ssd(paddle, tst.nn, paddle.ParamAttr, img)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb.numpy()))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.numpy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc.numpy()),
                                   rtol=1e-5, atol=1e-6)
        jloss = ssd_loss(pt, jl, jc, jb, jv, gts, labels)
        tloss = ssd_loss(paddle, tl, tc, tb, tv, gts, labels)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        jloss.backward()
        tloss.backward()
        for n in names:
            jg = np.asarray(scope.find_var(n).grad.numpy())
            tg = tst.global_scope().find_var(n).grad.numpy()
            np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-4 * max(
                np.abs(jg).max(), 1e-6), err_msg=n)
        # evaluation: decode, multiclass NMS, mAP on the same tensors
        maps = []
        for i in range(BSZ):
            jdec = pt.box_coder(jb, jv, jl[i], code_type="decode")
            tdec = paddle.box_coder(tb, tv, tl[i], code_type="decode")
            jsc = pt.nn.functional.softmax(jc[i], axis=-1).T
            tsc = paddle.nn.functional.softmax(tc[i], axis=-1).T
            np.testing.assert_allclose(tdec.numpy(),
                                       np.asarray(jdec.numpy()),
                                       rtol=1e-5, atol=1e-6)
            # the same input tensors into both NMS functions
            dec_np = np.asarray(jdec.numpy())
            sc_np = np.asarray(jsc.numpy())
            kw = dict(score_threshold=0.01, nms_top_k=40, keep_top_k=20,
                      iou_threshold=0.45, background_label=0)
            jo, jn = pt.multiclass_nms(pt.to_tensor(dec_np),
                                       pt.to_tensor(sc_np), **kw)
            to, tn = paddle.multiclass_nms(paddle.to_tensor(dec_np),
                                           paddle.to_tensor(sc_np), **kw)
            np.testing.assert_array_equal(to.numpy(),
                                          np.asarray(jo.numpy()))
            assert int(tn) == int(jn)
            det = np.asarray(jo.numpy())[:int(jn)]
            a = jmap(det, gts[i], labels[i], NCLS)
            b = tmap(det, gts[i], labels[i], NCLS)
            assert a == b
            maps.append(float(b))
        assert all(np.isfinite(maps))


def _named_ssd(pkg, sn, attr, img):
    """``ssd_forward`` with every head parameter named, so the port's
    scope can take the JAX scope's values."""
    x = pkg.to_tensor(img)
    f1 = sn.conv2d(x, 8, 3, stride=4, padding=1, act="relu",
                   param_attr=attr(name="c1_w"), bias_attr=attr(name="c1_b"))
    f2 = sn.conv2d(f1, 8, 3, stride=2, padding=1, act="relu",
                   param_attr=attr(name="c2_w"), bias_attr=attr(name="c2_b"))
    heads = []
    for k, (feat, ms, mx, ar) in enumerate(zip(
            [f1, f2], [12.0, 28.0], [[], [40.0]], [[2.0], [2.0, 3.0]])):
        boxes, var = pkg.prior_box(int(feat.shape[2]), int(feat.shape[3]),
                                   IMG, IMG, [ms], max_sizes=mx,
                                   aspect_ratios=ar, flip=True)
        npr = int(boxes.shape[2])
        loc = sn.conv2d(feat, npr * 4, 3, padding=1,
                        param_attr=attr(name=f"loc{k}_w"),
                        bias_attr=attr(name=f"loc{k}_b"))
        conf = sn.conv2d(feat, npr * NCLS, 3, padding=1,
                         param_attr=attr(name=f"conf{k}_w"),
                         bias_attr=attr(name=f"conf{k}_b"))
        heads.append((loc.transpose([0, 2, 3, 1]).reshape([BSZ, -1, 4]),
                      conf.transpose([0, 2, 3, 1]).reshape(
                          [BSZ, -1, NCLS]),
                      boxes.reshape([-1, 4]), var.reshape([-1, 4])))
    return tuple(pkg.concat([h[k] for h in heads], axis=1 if k < 2 else 0)
                 for k in range(4))
