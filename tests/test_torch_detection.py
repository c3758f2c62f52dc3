"""The detection paths, the port against the JAX package, on the CPU.

Small copies of the repo's two detection examples run on both packages
from the same weights and batches: ``example/rcnn/train_end2end.py``'s
Faster R-CNN loop (host-side anchor and proposal targets, ``Proposal``
under ``autograd.pause()``, ``take``, ``ROIPooling``, the two-stage losses,
``gluon.Trainer`` SGD with momentum and weight decay) over a 2-conv
stride-16 backbone on 64x64 images (144 anchors), and
``example/ssd/train_ssd.py``'s ``build_ssd`` graph through ``Module``
(``MultiBoxPrior``/``Target``/``Detection`` inside the training graph)
at its own 32x32 size.  After two steps the losses, the outputs and
the updated weights agree within 1e-4 of each one's largest.  The port's
copies of the examples live here: ``example/`` is the JAX package's.
"""
import numpy as np

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

TOL = 1e-4
FEAT_STRIDE = 16
SCALES = (2.0, 4.0, 8.0)
RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = 9
NUM_CLASSES = 4
ROI_PER_IMG = 8
POOLED = (7, 7)
SIZE = 64


def _np(x):
    return x.asnumpy() if isinstance(x, mxj.nd.NDArray) else \
        mxt.nd.asnumpy(x)


def close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() or 1.0
    assert np.abs(got - want).max() <= tol * scale, \
        (what, np.abs(got - want).max(), scale)


def _ctx(mx):
    return mxt.cpu() if mx is mxt else mxj.cpu()


# -- Faster R-CNN (example/rcnn/train_end2end.py, cut to 64x64) --------------
def make_batch(rs, n, size):
    """The example's synthetic images: bright rectangles on noise, classes
    by aspect (tall / wide / square), up to 2 boxes an image."""
    imgs = rs.normal(0, 0.1, (n, 3, size, size)).astype(np.float32)
    gt = np.zeros((n, 2, 5), np.float32)
    for i in range(n):
        for b in range(rs.randint(1, 3)):
            cls = rs.randint(1, NUM_CLASSES)
            w = rs.randint(12, 32)
            h = min({1: w * 2, 2: w // 2, 3: w}[cls], size - 2)
            x1 = rs.randint(0, size - w)
            y1 = rs.randint(0, size - h)
            imgs[i, :, y1:y1 + h, x1:x1 + w] += rs.uniform(0.8, 1.2)
            gt[i, b] = [cls, x1, y1, x1 + w - 1, y1 + h - 1]
    return imgs, gt


def gen_anchors(fh, fw):
    base = []
    ctr = (FEAT_STRIDE - 1) / 2.0
    for r in RATIOS:
        for s in SCALES:
            w = FEAT_STRIDE * s * np.sqrt(1.0 / r)
            h = FEAT_STRIDE * s * np.sqrt(r)
            base.append([ctr - 0.5 * (w - 1), ctr - 0.5 * (h - 1),
                         ctr + 0.5 * (w - 1), ctr + 0.5 * (h - 1)])
    base = np.asarray(base, np.float32)
    sxx, syy = np.meshgrid(np.arange(fw) * FEAT_STRIDE,
                           np.arange(fh) * FEAT_STRIDE)
    shifts = np.stack([sxx, syy, sxx, syy], -1).reshape(-1, 1, 4)
    return (base[None] + shifts).reshape(-1, 4)


def iou_matrix(a, b):
    iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0)
    ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0)
    inter = iw * ih
    aa = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    bb = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / np.maximum(aa[:, None] + bb[None] - inter, 1e-9)


def bbox_transform(anchors, gt):
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    gw = gt[:, 2] - gt[:, 0] + 1
    gh = gt[:, 3] - gt[:, 1] + 1
    gcx = gt[:, 0] + 0.5 * (gw - 1)
    gcy = gt[:, 1] + 0.5 * (gh - 1)
    return np.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                     np.log(gw / aw), np.log(gh / ah)], -1).astype(np.float32)


def anchor_targets(anchors, gt_boxes, size, fg_iou=0.5, bg_iou=0.3):
    K = anchors.shape[0]
    labels = -np.ones(K, np.float32)
    targets = np.zeros((K, 4), np.float32)
    inside = ((anchors[:, 0] >= -8) & (anchors[:, 1] >= -8) &
              (anchors[:, 2] < size + 8) & (anchors[:, 3] < size + 8))
    valid = gt_boxes[gt_boxes[:, 0] > 0][:, 1:]
    if len(valid) == 0:
        labels[inside] = 0
        return labels, targets
    iou = iou_matrix(anchors, valid)
    best, argbest = iou.max(1), iou.argmax(1)
    labels[inside & (best < bg_iou)] = 0
    labels[inside & (best >= fg_iou)] = 1
    labels[iou.argmax(0)] = 1
    fg = labels == 1
    targets[fg] = bbox_transform(anchors[fg], valid[argbest[fg]])
    return labels, targets


def proposal_targets(rois, gt_boxes, fg_iou=0.5):
    valid = gt_boxes[gt_boxes[:, 0] > 0]
    n = rois.shape[0]
    labels = np.zeros(n, np.float32)
    targets = np.zeros((n, 4 * NUM_CLASSES), np.float32)
    weights = np.zeros((n, 4 * NUM_CLASSES), np.float32)
    if len(valid):
        iou = iou_matrix(rois[:, 1:], valid[:, 1:])
        best, arg = iou.max(1), iou.argmax(1)
        fg = best >= fg_iou
        labels[fg] = valid[arg[fg], 0]
        t = bbox_transform(rois[fg, 1:], valid[arg[fg], 1:])
        for j, cls in enumerate(labels[fg].astype(int)):
            row = np.where(fg)[0][j]
            targets[row, 4 * cls:4 * cls + 4] = t[j]
            weights[row, 4 * cls:4 * cls + 4] = 1.0
    fg_idx = np.where(labels > 0)[0]
    bg_idx = np.where(labels == 0)[0]
    keep = np.concatenate([fg_idx[:ROI_PER_IMG // 2], bg_idx])[:ROI_PER_IMG]
    if len(keep) < ROI_PER_IMG:
        keep = np.concatenate(
            [keep, np.zeros(ROI_PER_IMG - len(keep), np.int64)])
    return keep, labels[keep], targets[keep], weights[keep]


def rcnn_nets(mx):
    nn = mx.gluon.nn
    bb = nn.HybridSequential(prefix="bb_")
    with bb.name_scope():
        bb.add(nn.Conv2D(8, 3, padding=1, activation="relu", in_channels=3))
        bb.add(nn.MaxPool2D(4, 4))
        bb.add(nn.Conv2D(16, 3, padding=1, activation="relu",
                         in_channels=8))
        bb.add(nn.MaxPool2D(4, 4))
    layers = [bb,
              nn.Conv2D(16, 3, padding=1, activation="relu", in_channels=16,
                        prefix="rpn_conv_"),
              nn.Conv2D(2 * NUM_ANCHORS, 1, in_channels=16, prefix="rpn_cls_"),
              nn.Conv2D(4 * NUM_ANCHORS, 1, in_channels=16, prefix="rpn_reg_"),
              nn.Dense(32, activation="relu", in_units=16 * 49,
                       prefix="fc1_"),
              nn.Dense(NUM_CLASSES, in_units=32, prefix="cls_"),
              nn.Dense(4 * NUM_CLASSES, in_units=32, prefix="reg_")]
    params = {}
    for blk in layers:
        blk.initialize(mx.init.Xavier(magnitude=2.0), ctx=_ctx(mx))
        params.update(blk.collect_params())
    return layers, params


def rcnn_step(mx, layers, trainer, imgs, gt, anchors, post_nms=16):
    """One step of the example's loop; returns its four losses."""
    bb, rpn_conv, rpn_cls, rpn_reg, fc1, hcls, hreg = layers
    ctx, nd = _ctx(mx), mx.nd
    B = imgs.shape[0]
    fh = fw = SIZE // FEAT_STRIDE
    x = nd.array(imgs, ctx=ctx)
    pairs = [anchor_targets(anchors, gt[i], SIZE) for i in range(B)]
    rpn_label = nd.array(np.stack([p[0] for p in pairs]), ctx=ctx)
    rpn_tgt = nd.array(np.stack([p[1] for p in pairs]), ctx=ctx)
    im_info = nd.array(np.tile([SIZE, SIZE, 1.0], (B, 1)).astype(np.float32),
                       ctx=ctx)
    with mx.autograd.record():
        feat = bb(x)
        h = rpn_conv(feat)
        cls_raw, reg_raw = rpn_cls(h), rpn_reg(h)
        cls_sm = nd.reshape(nd.transpose(nd.reshape(
            cls_raw, shape=(B, 2, NUM_ANCHORS, fh, fw)), axes=(0, 3, 4, 2, 1)),
            shape=(B, -1, 2))
        reg = nd.reshape(nd.transpose(nd.reshape(
            reg_raw, shape=(B, NUM_ANCHORS, 4, fh, fw)), axes=(0, 3, 4, 1, 2)),
            shape=(B, -1, 4))
        logp = nd.log_softmax(cls_sm, axis=-1)
        mask_fg = nd.equal(rpn_label, 1)
        mask_val = nd.greater_equal(rpn_label, 0)
        picked = nd.pick(logp, nd.maximum(rpn_label, 0), axis=2)
        rpn_cls_loss = -nd.sum(picked * mask_val) / \
            nd.maximum(nd.sum(mask_val), 1)
        diff = nd.smooth_l1(reg - rpn_tgt, scalar=3.0)
        rpn_reg_loss = nd.sum(nd.sum(diff, axis=2) * mask_fg) / \
            nd.maximum(nd.sum(mask_fg), 1)
        with mx.autograd.pause():
            probs = nd.reshape(nd.softmax(nd.reshape(
                cls_raw, shape=(B, 2, NUM_ANCHORS * fh, fw)), axis=1),
                shape=(B, 2 * NUM_ANCHORS, fh, fw))
            rois = nd.Proposal(probs, reg_raw, im_info, scales=SCALES,
                               ratios=RATIOS, feature_stride=FEAT_STRIDE,
                               rpn_pre_nms_top_n=128,
                               rpn_post_nms_top_n=post_nms,
                               rpn_min_size=4, threshold=0.7)
            rois_np = _np(rois)
            keep_all, lab_l, tgt_l, wt_l = [], [], [], []
            for i in range(B):
                r = rois_np[rois_np[:, 0] == i]
                k, lab, t, w = proposal_targets(r, gt[i])
                base = np.where(rois_np[:, 0] == i)[0]
                keep_all.append(base[np.minimum(k, len(base) - 1)])
                lab_l.append(lab)
                tgt_l.append(t)
                wt_l.append(w)
            keep_idx = nd.array(np.concatenate(keep_all).astype(np.int32),
                                ctx=ctx)
            roi_label = nd.array(np.concatenate(lab_l), ctx=ctx)
            roi_tgt = nd.array(np.concatenate(tgt_l), ctx=ctx)
            roi_wt = nd.array(np.concatenate(wt_l), ctx=ctx)
            sel_rois = nd.take(rois, keep_idx)
        pooled = nd.ROIPooling(feat, sel_rois, pooled_size=POOLED,
                               spatial_scale=1.0 / FEAT_STRIDE)
        hid = fc1(pooled)
        cls_pred, reg_pred = hcls(hid), hreg(hid)
        cls_loss = -nd.mean(nd.pick(nd.log_softmax(cls_pred, axis=-1),
                                    roi_label, axis=1))
        reg_loss = nd.sum(nd.smooth_l1(reg_pred - roi_tgt, scalar=1.0)
                          * roi_wt) / nd.maximum(nd.sum(roi_wt) / 4, 1)
        loss = rpn_cls_loss + rpn_reg_loss + cls_loss + reg_loss
    loss.backward()
    trainer.step(B)
    return [float(_np(v)) for v in (rpn_cls_loss, rpn_reg_loss, cls_loss,
                                    reg_loss)], rois_np


def test_rcnn_loop_matches_jax():
    """Two steps of the R-CNN loop from the same weights and batches:
    proposals, losses and every updated weight."""
    jlayers, jparams = rcnn_nets(mxj)
    tlayers, tparams = rcnn_nets(mxt)
    assert sorted(jparams) == sorted(tparams)
    for name, p in jparams.items():
        tparams[name].set_data(mxt.nd.array(p.data().asnumpy(),
                                            ctx=mxt.cpu()))
    opt = {"learning_rate": 0.003, "momentum": 0.9, "wd": 5e-4}
    jtr = mxj.gluon.Trainer(jparams, "sgd", dict(opt))
    ttr = mxt.gluon.Trainer(tparams, "sgd", dict(opt))
    anchors = gen_anchors(SIZE // FEAT_STRIDE, SIZE // FEAT_STRIDE)
    rs = np.random.RandomState(0)
    for step in range(2):
        imgs, gt = make_batch(rs, 2, SIZE)
        jl, jrois = rcnn_step(mxj, jlayers, jtr, imgs, gt, anchors)
        tl, trois = rcnn_step(mxt, tlayers, ttr, imgs, gt, anchors)
        close(trois, jrois, what=f"rois, step {step}")
        for a, b, what in zip(tl, jl, ("rpn_cls", "rpn_reg", "cls", "reg")):
            close([a], [b], what=f"{what} loss, step {step}")
    for name, p in jparams.items():
        close(_np(tparams[name].data()), p.data().asnumpy(), what=name)


# -- SSD (example/ssd/train_ssd.py's build_ssd) -------------------------------
def conv_act(mx, data, num_filter, name, stride=(1, 1)):
    c = mx.sym.Convolution(data, num_filter=num_filter, kernel=(3, 3),
                           stride=stride, pad=(1, 1), name=name)
    b = mx.sym.BatchNorm(c, name=name + "_bn")
    return mx.sym.Activation(b, act_type="relu", name=name + "_relu")


def build_ssd(mx, num_classes, ratios=(1.0, 2.0, 0.5)):
    """The example's graph: a 4-conv body, heads at 16x16 and 8x8, priors,
    targets, the masked losses and the detections."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    body = conv_act(mx, data, 16, "c1")
    body = conv_act(mx, body, 32, "c2", stride=(2, 2))
    scale1 = conv_act(mx, body, 32, "c3")
    scale2 = conv_act(mx, scale1, 64, "c4", stride=(2, 2))
    cls_preds, loc_preds, anchors = [], [], []
    for i, (feat, sizes) in enumerate([(scale1, (0.2, 0.35)),
                                       (scale2, (0.5, 0.75))]):
        na = len(sizes) + len(ratios) - 1
        cp = mx.sym.Convolution(feat, num_filter=na * (num_classes + 1),
                                kernel=(3, 3), pad=(1, 1), name=f"clspred{i}")
        cp = mx.sym.transpose(cp, axes=(0, 2, 3, 1))
        cls_preds.append(mx.sym.Reshape(cp, shape=(0, -1, num_classes + 1)))
        lp = mx.sym.Convolution(feat, num_filter=na * 4, kernel=(3, 3),
                                pad=(1, 1), name=f"locpred{i}")
        lp = mx.sym.transpose(lp, axes=(0, 2, 3, 1))
        loc_preds.append(mx.sym.Reshape(lp, shape=(0, -1)))
        anchors.append(mx.sym.MultiBoxPrior(feat, sizes=sizes, ratios=ratios,
                                            clip=True))
    cls_pred = mx.sym.transpose(mx.sym.Concat(*cls_preds, dim=1),
                                axes=(0, 2, 1))
    loc_pred = mx.sym.Concat(*loc_preds, dim=1)
    anchor = mx.sym.Concat(*anchors, dim=1)
    loc_t, loc_m, cls_t = mx.sym.MultiBoxTarget(
        anchor, label, cls_pred, overlap_threshold=0.5,
        negative_mining_ratio=3, variances=(0.1, 0.1, 0.2, 0.2))
    cls_prob = mx.sym.SoftmaxOutput(cls_pred, cls_t, multi_output=True,
                                    use_ignore=True, ignore_label=-1,
                                    normalization="valid", name="cls_prob")
    loc_loss = mx.sym.MakeLoss(
        mx.sym.smooth_l1(loc_m * (loc_pred - loc_t), scalar=1.0,
                         name="loc_loss_"),
        grad_scale=1.0, normalization="valid", name="loc_loss")
    cls_label = mx.sym.MakeLoss(cls_t, grad_scale=0, name="cls_label")
    det = mx.sym.MultiBoxDetection(cls_prob, loc_pred, anchor,
                                   name="detection", nms_threshold=0.5)
    det = mx.sym.MakeLoss(det, grad_scale=0, name="det_out")
    return mx.sym.Group([cls_prob, loc_loss, cls_label, det])


def synthetic_detection_batch(rs, batch, num_classes, size=32):
    imgs = rs.normal(0, 0.1, (batch, 3, size, size)).astype("f")
    labels = np.zeros((batch, 1, 5), "f")
    for i in range(batch):
        cls = rs.randint(num_classes)
        w, h = rs.uniform(0.3, 0.6, 2)
        x1 = rs.uniform(0, 1 - w)
        y1 = rs.uniform(0, 1 - h)
        xi1, yi1 = int(x1 * size), int(y1 * size)
        xi2, yi2 = int((x1 + w) * size), int((y1 + h) * size)
        imgs[i, cls % 3, yi1:yi2, xi1:xi2] += 1.0 + 0.5 * cls
        labels[i, 0] = [cls, x1, y1, x1 + w, y1 + h]
    return imgs, labels


# The example trains at lr 0.005, where its first step moves c1's weights
# by up to 0.4: the second step's gradients, over BatchNorm on 4 images,
# then differ by about 2e-4 of their largest from the first step's
# last-bit differences alone.  The comparison takes lr 5e-4, and holds the
# first step's gradients, from the same weights, at 1e-5.
SSD_LR = 5e-4
# a convolution's bias in front of BatchNorm has a gradient of 0 but for
# rounding (the normalisation takes it out again): its gradient and value
# are held against the net's largest instead of their own
BN_FED_BIASES = ("c1_bias", "c2_bias", "c3_bias", "c4_bias")


def ssd_module(mx, batch, arg=None, aux=None):
    mod = mx.mod.Module(build_ssd(mx, 3), data_names=("data",),
                        label_names=("label",), context=_ctx(mx))
    mod.bind(data_shapes=[("data", (batch, 3, 32, 32))],
             label_shapes=[("label", (batch, 1, 5))])
    if arg is None:
        mod.init_params(mx.init.Xavier(magnitude=2))
    else:
        mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": SSD_LR,
                                         "momentum": 0.9})
    return mod


def test_ssd_module_step_matches_jax():
    """Two ``Module`` steps of the example's SSD graph (B=4): the first
    step's gradients, the outputs after each step (class probabilities,
    the masked loss, the targets; the decoded and suppressed detections of
    the first) and the updated weights.  SGD with momentum stands in for
    the example's Adam: Adam divides each gradient by its own size, so
    where a gradient is 0 but for rounding (``BN_FED_BIASES``) the two
    packages' last-bit differences become steps of +-lr."""
    jmod = ssd_module(mxj, 4)
    jarg, jaux = jmod.get_params()
    tmod = ssd_module(mxt, 4,
                      {k: mxt.nd.array(v.asnumpy(), ctx=mxt.cpu())
                       for k, v in jarg.items()},
                      {k: mxt.nd.array(v.asnumpy(), ctx=mxt.cpu())
                       for k, v in jaux.items()})
    rs = np.random.RandomState(0)
    for step in range(2):
        imgs, labels = synthetic_detection_batch(rs, 4, 3)
        for mx, mod in ((mxj, jmod), (mxt, tmod)):
            mod.forward_backward(mx.io.DataBatch(
                data=[mx.nd.array(imgs, ctx=_ctx(mx))],
                label=[mx.nd.array(labels, ctx=_ctx(mx))]))
        if step == 0:
            jg = {k: v.asnumpy() for k, v in jmod._exec.grad_dict.items()
                  if v is not None}
            top = max(np.abs(v).max() for v in jg.values())
            for name, want in jg.items():
                got = _np(tmod._exec.grad_dict[name])
                if name in BN_FED_BIASES:
                    assert np.abs(got - want).max() <= 1e-5 * top, name
                else:
                    close(got, want, 1e-5, what=f"gradient of {name}")
        for mod in (jmod, tmod):
            mod.update()
        jouts = [o.asnumpy() for o in jmod.get_outputs()]
        touts = [_np(o) for o in tmod.get_outputs()]
        for i, (g, w) in enumerate(zip(touts[:3], jouts[:3])):
            close(g, w, what=f"output {i}, step {step}")
        np.testing.assert_array_equal(touts[2], jouts[2])   # class targets
        if step == 0:
            # the detections from the same weights: the same rows, kept
            # and suppressed alike.  After an update the two packages'
            # weights differ in the last bits, and a near-tie in score
            # order or an IoU next to the threshold may then decide
            # otherwise, so step 2 holds the losses and weights instead.
            close(touts[3], jouts[3], what="detections")
            np.testing.assert_array_equal(touts[3][..., 0],
                                          jouts[3][..., 0])
    targ, taux = tmod.get_params()
    jarg, jaux = jmod.get_params()
    top = max(np.abs(v.asnumpy()).max() for v in jarg.values())
    for name in jarg:
        got, want = _np(targ[name]), jarg[name].asnumpy()
        if name in BN_FED_BIASES:
            assert np.abs(got - want).max() <= TOL * top, name
        else:
            close(got, want, what=name)
    for name in jaux:
        close(_np(taux[name]), jaux[name].asnumpy(), what=name)
