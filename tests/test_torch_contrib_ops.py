"""The rest of the op registry against the JAX package's, on the CPU.

The same numpy inputs, made from seeds, go through ``mxnet_tpu`` and
``mxnet_tpu_torch``: the alias table and the registry's coverage; every op
of ``ops/compat.py``, ``ops/contrib.py`` (fft, quantization, count sketch,
Khatri-Rao, the SSD and R-CNN ops, the deformable ops) and
``ops/vision.py``, outputs and the gradients of ``sum(out * w)`` within
1e-5 of each one's largest (exact for integers, masks, class ids and
keep sets); the detection trouble spots (an IoU exactly at the NMS
threshold, tied scores, ``MultiBoxTarget``'s duplicate and padded-row
scatters, ROI pooling over tied ReLU zeros, overlapping and empty bins
and bf16 ROIs, ``Proposal``'s padding and scores); the ``Custom`` op in
``nd``, under ``record()``, in a Symbol under ``Module``, and refused
inside a CUDA graph capture.  On the CPU the kernels' plain versions run.
The JAX side of each case is one jitted program (outputs and VJP), so the
file stays cheap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops import registry as JR
from mxnet_tpu_torch.ops import custom as tcustom
from mxnet_tpu_torch.ops import registry as TR

CPU = mxt.cpu()
TOL = 1e-5
SPARSE_LEFT = {"_square_sum", "cast_storage", "sparse_retain"}


def _params(op, kw):
    p = dict(op.normalize(kw))
    if op.takes_is_train:
        p["__is_train__"] = False
    return p


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating) or \
        str(np.asarray(a).dtype) == "bfloat16"


def jax_case(name, arrays, kw, wrt, seed=1):
    """(outputs, grads of sum(out * w) w.r.t. inputs ``wrt``, the w) of
    the JAX op as one jitted program; w drawn from ``seed`` per float
    output that is not an aux state's new value."""
    op = JR.get_op(name)
    p = _params(op, kw)
    xs = [jnp.asarray(a) for a in arrays]

    def fwd(*ins):
        out = op.fn(p, *ins)
        return out if isinstance(out, tuple) else (out,)

    outs = [np.asarray(o) for o in jax.jit(fwd)(*xs)]
    if not wrt:
        return outs, []
    rs = np.random.RandomState(seed)
    n_vis = len(outs) - len(op.aux_inputs)     # aux outputs take no weight
    ws = [rs.standard_normal(o.shape).astype(np.float32)
          if _is_float(o) and i < n_vis else None
          for i, o in enumerate(outs)]

    def loss(*sub):
        full = list(xs)
        for i, v in zip(wrt, sub):
            full[i] = v
        return sum(jnp.sum(o * w) for o, w in zip(fwd(*full), ws)
                   if w is not None)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(wrt)))))(
        *[xs[i] for i in wrt])
    return outs, [np.asarray(g) for g in grads], ws


def torch_case(name, arrays, kw, wrt, ws=None):
    op = TR.get_op(name)
    p = _params(op, kw)
    xs = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in wrt:
        xs[i].requires_grad_(True)
    out = op.fn(p, *xs)
    out = out if isinstance(out, tuple) else (out,)
    if not wrt:
        return [o.detach() for o in out], []
    loss = sum((o * torch.from_numpy(w).to(o.dtype)).sum()
               for o, w in zip(out, ws) if w is not None)
    grads = torch.autograd.grad(loss, [xs[i] for i in wrt])
    return [o.detach() for o in out], list(grads)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def close(got, want, tol=TOL, what=""):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    scale = np.abs(want).max() or 1.0
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


def compare(name, arrays, kw, wrt=(), exact=(), tol=TOL):
    """The op's outputs (``exact``: output indices compared bitwise, or
    (index, column) pairs) and its gradients, port against JAX."""
    res = jax_case(name, arrays, kw, wrt)
    want, wgrads = res[0], res[1]
    got, tgrads = torch_case(name, arrays, kw, wrt,
                             res[2] if wrt else None)
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        if i in exact or not _is_float(w):
            np.testing.assert_array_equal(_f64(g), _f64(w), err_msg=name)
        else:
            close(g, w, tol, f"{name} output {i}")
        for j, col in (e for e in exact if isinstance(e, tuple)):
            if j == i:
                np.testing.assert_array_equal(_f64(g)[..., col],
                                              _f64(w)[..., col],
                                              err_msg=f"{name} column {col}")
    for i, (g, w) in zip(wrt, zip(tgrads, wgrads)):
        close(g, w, tol, f"{name} grad of input {i}")
    return got, want


# -- the registry -----------------------------------------------------------
def test_aliases_match_jax_where_both_have_the_target():
    missing, wrong = [], []
    for alias, target in JR.OP_ALIASES.items():
        if target not in TR.OP_REGISTRY:
            assert target in SPARSE_LEFT, (alias, target)
            continue
        got = TR.OP_ALIASES.get(alias, alias if alias in TR.OP_REGISTRY
                                else None)
        if got is None:
            missing.append(alias)
        elif got != target and alias not in TR.OP_REGISTRY:
            wrong.append((alias, got, target))
    assert not missing and not wrong, (missing, wrong)


def test_registry_lacks_only_the_sparse_ops():
    assert set(JR.OP_REGISTRY) - set(TR.OP_REGISTRY) == SPARSE_LEFT
    assert len(TR.OP_REGISTRY) == 230
    for name in ("_grad_add", "CuDNNBatchNorm", "_linalg_gemm",
                 "_scatter_plus_scalar", "_contrib_SparseEmbedding"):
        assert TR.get_op(name).name == JR.get_op(name).name


# -- every new op -------------------------------------------------------------
def _rs(seed=0):
    return np.random.RandomState(seed)


def _anchors(h=6, w=6):
    op = JR.get_op("_contrib_MultiBoxPrior")
    return np.asarray(op.fn(dict(op.normalize(
        {"sizes": (0.2, 0.35), "ratios": (1, 2, 0.5)})),
        jnp.zeros((1, 3, h, w)))).astype(np.float32)


_ROIS = np.array([[0, 1, 2, 30, 20], [1, 5, 4, 50, 60], [0, 60, 60, 70, 70],
                  [1, -8, -8, 20, 9]], np.float32)
_B = _rs(3).randn(2, 5, 5).astype(np.float32)

CASES = {
    "fft": ("_contrib_fft", [_rs().randn(3, 8).astype(np.float32)], {},
            (0,)),
    "ifft": ("_contrib_ifft", [_rs().randn(3, 16).astype(np.float32)], {},
             (0,)),
    "quantize_uint8": ("_contrib_quantize",
                       [_rs().rand(3, 8).astype(np.float32),
                        np.array([0.1], np.float32),
                        np.array([0.9], np.float32)], {}, ()),
    "quantize_int8": ("_contrib_quantize",
                      [_rs(1).rand(3, 8).astype(np.float32) * 2 - 1,
                       np.array([-1.0], np.float32),
                       np.array([1.0], np.float32)],
                      {"out_type": "int8"}, ()),
    "dequantize": ("_contrib_dequantize",
                   [_rs().randint(0, 255, (3, 8)).astype(np.uint8),
                    np.array([0.1], np.float32),
                    np.array([0.9], np.float32)], {}, ()),
    "count_sketch": ("_contrib_count_sketch",
                     [_rs().randn(3, 8).astype(np.float32),
                      np.array([0, 1, 1, 3, 2, 0, 4, 4], np.float32),
                      np.sign(_rs(2).randn(8)).astype(np.float32)],
                     {"out_dim": 5}, (0,)),
    "khatri_rao": ("khatri_rao", [_rs().randn(2, 3).astype(np.float32),
                                  _rs(1).randn(4, 3).astype(np.float32)],
                   {}, (0, 1)),
    "multibox_prior": ("_contrib_MultiBoxPrior",
                       [np.zeros((1, 3, 4, 5), np.float32)],
                       {"sizes": (0.2, 0.35), "ratios": (1, 2, 0.5),
                        "clip": True, "steps": (0.3, 0.2)}, ()),
    "psroi": ("_contrib_PSROIPooling",
              [_rs().randn(2, 2 * 2 * 2, 8, 9).astype(np.float32), _ROIS],
              {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 2},
              (0,)),
    "deformable_conv": ("_contrib_DeformableConvolution",
                        [_rs().randn(2, 4, 6, 7).astype(np.float32),
                         _rs(1).randn(2, 2 * 2 * 9, 6, 7).astype(np.float32),
                         _rs(2).randn(6, 2, 3, 3).astype(np.float32),
                         _rs(3).randn(6).astype(np.float32)],
                        {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
                         "num_group": 2, "num_deformable_group": 2},
                        (0, 1, 2, 3)),
    "deformable_psroi": ("_contrib_DeformablePSROIPooling",
                         [_rs().randn(2, 2 * 2 * 2, 8, 9).astype(np.float32),
                          _ROIS, _rs(1).randn(4, 4, 2, 2).astype(np.float32)],
                         {"spatial_scale": 0.125, "output_dim": 2,
                          "pooled_size": 2, "group_size": 2,
                          "sample_per_part": 3, "trans_std": 0.1}, (0, 2)),
    "grid_affine": ("GridGenerator", [_rs().randn(2, 6).astype(np.float32)],
                    {"transform_type": "affine", "target_shape": (4, 5)},
                    (0,)),
    "grid_warp": ("GridGenerator",
                  [_rs().randn(2, 2, 4, 5).astype(np.float32)],
                  {"transform_type": "warp"}, (0,)),
    "bilinear_sampler": ("BilinearSampler",
                         [_rs().randn(2, 3, 6, 7).astype(np.float32),
                          (_rs(1).rand(2, 2, 4, 5) * 2.4 - 1.2)
                          .astype(np.float32)], {}, (0, 1)),
    "spatial_transformer": ("SpatialTransformer",
                            [_rs().randn(2, 3, 6, 7).astype(np.float32),
                             (_rs(1).randn(2, 6) * 0.5).astype(np.float32)],
                            {"target_shape": (4, 5)}, (0, 1)),
    "crop_center": ("Crop", [_rs().randn(2, 3, 6, 7).astype(np.float32)],
                    {"num_args": 1, "h_w": (3, 4), "center_crop": True},
                    (0,)),
    "crop_like": ("Crop", [_rs().randn(2, 3, 6, 7).astype(np.float32),
                           np.zeros((2, 3, 4, 4), np.float32)],
                  {"num_args": 2, "offset": (1, 2)}, (0,)),
    "correlation": ("Correlation",
                    [_rs().randn(2, 3, 6, 7).astype(np.float32),
                     _rs(1).randn(2, 3, 6, 7).astype(np.float32)],
                    {"max_displacement": 2, "stride2": 1, "pad_size": 2},
                    (0, 1)),
    "correlation_abs": ("Correlation",
                        [_rs().randn(1, 2, 5, 5).astype(np.float32),
                         _rs(1).randn(1, 2, 5, 5).astype(np.float32)],
                        {"max_displacement": 1, "is_multiply": False},
                        (0, 1)),
    "slice_assign": ("_slice_assign",
                     [_rs().randn(4, 5).astype(np.float32),
                      _rs(1).randn(2, 2).astype(np.float32)],
                     {"begin": (1, None), "end": (3, 4), "step": (None, 2)},
                     (0, 1)),
    "slice_assign_scalar": ("_slice_assign_scalar",
                            [_rs().randn(4, 5).astype(np.float32)],
                            {"scalar": 3.0, "begin": (1, 0),
                             "end": (3, 4)}, (0,)),
    "gelqf": ("_linalg_gelqf", [_rs().randn(2, 3, 5).astype(np.float32)],
              {}, (0,)),
    "syevd": ("_linalg_syevd", [_B + _B.transpose(0, 2, 1)], {}, (0,)),
    "kl_sparse_reg": ("IdentityAttachKLSparseReg",
                      [_rs().rand(4, 6).astype(np.float32),
                       np.linspace(0.1, 0.9, 6).astype(np.float32)],
                      {"penalty": 0.01}, (0,)),
    "identity_like_rhs": ("_identity_with_attr_like_rhs",
                          [_rs().rand(4, 6).astype(np.float32),
                           _rs(1).rand(4, 6).astype(np.float32)], {}, (0,)),
    "roi_pooling": ("ROIPooling",
                    [_rs().randn(2, 3, 8, 9).astype(np.float32), _ROIS],
                    {"pooled_size": (3, 2), "spatial_scale": 0.125}, (0,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    name, arrays, kw, wrt = CASES[case]
    compare(name, arrays, kw, wrt)


def test_aux_moving_average_is_written_back():
    """IdentityAttachKLSparseReg through ``nd``: the moving average aux
    tensor takes the new value, as the JAX package writes it back."""
    x = _rs().rand(4, 6).astype(np.float32)
    avg0 = np.full(6, 0.5, np.float32)
    ja = mxj.nd.array(avg0)
    mxj.nd.IdentityAttachKLSparseReg(mxj.nd.array(x), ja)
    ta = mxt.nd.array(avg0, ctx=CPU)
    mxt.nd.IdentityAttachKLSparseReg(mxt.nd.array(x, ctx=CPU), ta)
    close(ta, ja.asnumpy())
    assert not np.allclose(mxt.nd.asnumpy(ta), avg0)


# -- SSD ops and their trouble spots ------------------------------------------
def test_multibox_target_matches_jax():
    anc = _anchors()
    A = anc.shape[1]
    lab = np.array([[[1, .1, .1, .4, .5], [0, .5, .5, .9, .8],
                     [-1, 0, 0, 0, 0]],
                    [[2, .2, .1, .6, .6], [-1, 0, 0, 0, 0],
                     [-1, 0, 0, 0, 0]]], np.float32)
    compare("_contrib_MultiBoxTarget", [anc, lab,
                                        np.zeros((2, 4, A), np.float32)],
            {"overlap_threshold": 0.4}, exact=(1, 2))


def test_multibox_target_duplicate_and_padded_scatters():
    """Two ground truths sharing a best anchor (the later row wins the
    forced match), and a padded row after a valid one whose best anchor
    is anchor 0: its IoUs are all -1, so its argmax is anchor 0 too, and
    its write clears the valid row's forced match there."""
    anc = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]],
                   np.float32)
    lab = np.array([
        # rows 0 and 1 both best at anchor 1; neither above 0.9
        [[1, .55, .55, .95, .95], [2, .6, .6, 1, 1], [-1, 0, 0, 0, 0]],
        # row 0 best at anchor 0, then a padded row names anchor 0 too
        [[3, .05, .05, .3, .3], [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0]],
        # padded rows first: the valid row after them keeps anchor 0
        [[-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0], [1, .05, .05, .3, .3]],
    ], np.float32)
    got, want = compare("_contrib_MultiBoxTarget",
                        [anc, lab, np.zeros((3, 4, 3), np.float32)],
                        {"overlap_threshold": 0.9}, exact=(1, 2))
    cls_t = _f64(want[2])
    assert cls_t[0].tolist() == [0, 3, 0]        # the later row, class 2
    assert cls_t[1].tolist() == [0, 0, 0]        # cleared by the pad row
    assert cls_t[2].tolist() == [2, 0, 0]


def test_multibox_detection_matches_jax():
    anc = _anchors()
    A = anc.shape[1]
    rs = _rs(5)
    probs = rs.rand(2, 4, A).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    loc = (rs.randn(2, A * 4) * 0.1).astype(np.float32)
    for kw in ({"threshold": 0.1}, {"threshold": 0.2, "force_suppress": True,
                                    "nms_threshold": 0.3},
               {"background_id": 2, "clip": False}):
        compare("_contrib_MultiBoxDetection", [probs, loc, anc], kw,
                exact=((0, 0),))


def test_multibox_detection_iou_at_threshold_and_tied_scores():
    """Pairs whose IoU is exactly 0.5 (kept: the rule is > 0.5) and just
    above it (suppressed); tied scores kept in index order."""
    anc = np.array([[[0, 0, .5, .25], [0, 0, .25, .25],
                     [.5, .5, 1, .75], [.5, .5, .7578125, .75],
                     [0, .5, .25, .75], [0, .5, .25, .75]]], np.float32)
    A = anc.shape[1]
    probs = np.zeros((1, 2, A), np.float32)
    probs[0, 1] = [.9, .8, .7, .6, .5, .5]
    probs[0, 0] = 1 - probs[0, 1]
    loc = np.zeros((1, A * 4), np.float32)
    got, want = compare("_contrib_MultiBoxDetection", [probs, loc, anc],
                        {"nms_threshold": 0.5}, exact=((0, 0),))
    ids = _f64(want[0])[0, :, 0].tolist()
    # box 1 (IoU 0.5 with box 0) kept, box 3 (IoU > 0.5 with 2) dropped,
    # the tied pair: the first kept, its twin (IoU 1) dropped
    assert ids == [0, 0, 0, -1, 0, -1], ids


# -- R-CNN ops and their trouble spots ----------------------------------------
def _rpn(seed, n, h, w, a):
    rs = _rs(seed)
    return (rs.rand(n, 2 * a, h, w).astype(np.float32),
            (rs.randn(n, 4 * a, h, w) * 0.2).astype(np.float32))


def test_proposal_matches_jax_with_scores_and_padding():
    cls_prob, bbox = _rpn(7, 2, 5, 6, 9)
    info = np.array([[80, 96, 1.0], [70, 90, 1.5]], np.float32)
    kw = {"scales": (2, 4, 8), "rpn_pre_nms_top_n": 120,
          "rpn_post_nms_top_n": 20, "rpn_min_size": 4, "output_score": True}
    compare("_contrib_Proposal", [cls_prob, bbox, info], kw,
            exact=((0, 0), 1))
    # a strict threshold keeps few boxes: the rest of the slots repeat
    # the best ROI with score 0
    kw.update(threshold=0.05, rpn_post_nms_top_n=60)
    got, want = compare("_contrib_Proposal", [cls_prob, bbox, info], kw,
                        exact=((0, 0), 1))
    rois, scores = _f64(want[0]), _f64(want[1])
    assert (scores == 0).any()
    pad = np.where(scores[:60, 0] == 0)[0]
    np.testing.assert_array_equal(rois[pad], np.repeat(rois[:1], len(pad), 0))
    compare("MultiProposal", [cls_prob, bbox, info],
            {"scales": (2, 4, 8), "rpn_pre_nms_top_n": 50,
             "rpn_post_nms_top_n": 10}, exact=((0, 0),))


def test_roi_pooling_ties_overlaps_empty_bins():
    """A ReLU map full of tied zeros (each tied maximum takes g / count),
    bins that overlap (rh = 7 over 3 bins), a ROI half off the map (empty
    bins: 0, no gradient), one past it."""
    x = np.maximum(_rs(4).randn(2, 3, 8, 9), 0).astype(np.float32)
    x[0, :, :4, :4] = 0.0
    rois = np.array([[0, 0, 0, 31, 31], [0, 0, 0, 55, 48],
                     [1, 40, 40, 120, 120], [1, 100, 100, 130, 130],
                     [0, 8, 8, 8, 8]], np.float32)
    compare("ROIPooling", [x, rois],
            {"pooled_size": (3, 3), "spatial_scale": 0.125}, (0,))


def test_roi_pooling_bf16_rounds_the_rois():
    """bf16 data: the ROIs are cast to bf16 before scaling (279 -> 280,
    so x2 rounds to 18 where float32 gives 17),
    as ``rois.astype(data.dtype)`` does; the max is exact."""
    x = _rs(6).randn(1, 2, 40, 40).astype(np.float32)
    rois = np.array([[0, 8, 8, 279, 500], [0, 3.3, 5.5, 100.7, 90.2]],
                    np.float32)
    kw = {"pooled_size": (2, 2), "spatial_scale": 0.0625}
    jo, to = JR.get_op("ROIPooling"), TR.get_op("ROIPooling")
    want = jax.jit(lambda a, r: jo.fn(dict(jo.normalize(kw)), a, r))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(rois))
    got = to.fn(dict(to.normalize(kw)), torch.from_numpy(x).bfloat16(),
                torch.from_numpy(rois))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    f32 = to.fn(dict(to.normalize(kw)), torch.from_numpy(x),
                torch.from_numpy(rois))
    assert not torch.equal(f32, got.float())   # the rounding shows


def test_roi_pooling_nd_under_record():
    """``nd.ROIPooling`` on the port's tensors under ``record()``: the
    plain backward's gradient, against JAX's, through ``backward()``."""
    x = np.maximum(_rs(8).randn(1, 4, 10, 12), 0).astype(np.float32)
    rois = np.array([[0, 0, 0, 70, 50], [0, 20, 10, 90, 79]], np.float32)
    res = jax_case("ROIPooling", [x, rois],
                   {"pooled_size": (4, 4), "spatial_scale": 0.125}, (0,))
    w = res[2][0]
    tx = mxt.nd.array(x, ctx=CPU)
    mxt.nd.attach_grad(tx)
    with mxt.autograd.record():
        out = mxt.nd.ROIPooling(tx, mxt.nd.array(rois, ctx=CPU),
                                pooled_size=(4, 4), spatial_scale=0.125)
        loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    close(out, res[0][0])
    close(tx.grad, res[1][0])


# -- Custom ---------------------------------------------------------------
@mxt.operator.register("sqr_t")
class SqrProp(mxt.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=True)

    def create_operator(self, ctx, shapes, dtypes):
        return Sqr()


class Sqr(mxt.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] * in_data[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])


def test_custom_nd_forward_and_backward():
    x0 = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    x = mxt.nd.array(x0, ctx=CPU)
    np.testing.assert_allclose(
        mxt.nd.asnumpy(mxt.nd.Custom(x, op_type="sqr_t")), x0 ** 2)
    mxt.nd.attach_grad(x)
    with mxt.autograd.record():
        y = mxt.nd.Custom(x, op_type="sqr_t")
        loss = y.sum()
    loss.backward()
    np.testing.assert_allclose(mxt.nd.asnumpy(x.grad), 2 * x0, rtol=1e-6)
    assert "sqr_t" in mxt.operator.get_all_registered_operators()


def test_custom_op_state_shared_between_forward_and_backward():
    @mxt.operator.register("stash_t")
    class StashProp(mxt.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class Stash(mxt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.saved = mxt.nd.asnumpy(in_data[0]) * 2.0
                    self.assign(out_data[0], req[0], in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    # nd.array lands on the op's device: the op runs in
                    # its context
                    self.assign(in_grad[0], req[0],
                                mxt.nd.array(self.saved) * out_grad[0])
            return Stash()

    x = mxt.nd.array(np.array([[1.0, 3.0]], np.float32), ctx=CPU)
    mxt.nd.attach_grad(x)
    with mxt.autograd.record():
        mxt.nd.Custom(x, op_type="stash_t").sum().backward()
    np.testing.assert_allclose(mxt.nd.asnumpy(x.grad), [[2.0, 6.0]])


def test_custom_symbol_inputs_and_infer_shape():
    @mxt.operator.register("concat_half")
    class HalfProp(mxt.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def infer_shape(self, in_shape):
            return [in_shape[0], in_shape[0]], \
                [(in_shape[0][0] * 2,) + tuple(in_shape[0][1:])], []

    a, b = mxt.sym.Variable("a"), mxt.sym.Variable("b")
    with pytest.raises(mxt.MXNetError):
        mxt.sym.Custom(a, b, op_type="sqr_t")
    out = mxt.sym.Custom(a, b, op_type="concat_half")
    _, out_shapes, _ = out.infer_shape(a=(2, 3), b=(2, 3))
    assert tuple(out_shapes[0]) == (4, 3)


@mxt.operator.register("softmax_t")
class _SoftmaxProp(mxt.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _Softmax()


class _Softmax(mxt.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], torch.softmax(in_data[0], dim=1))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        lab = in_data[1].long()
        y = out_data[0].clone()
        y[torch.arange(lab.shape[0]), lab] -= 1.0
        self.assign(in_grad[0], req[0], y)


def test_custom_softmax_module_trains():
    """upstream's ``example/numpy-ops/custom_softmax.py``: a Custom loss
    layer (need_top_grad=False) trains under ``Module.fit``; its label
    variable's shape comes from the prop."""
    rs = _rs(0)
    y = rs.randint(0, 4, 256)
    centers = rs.normal(0, 1, (4, 16))
    x = (centers[y] + rs.normal(0, 0.2, (256, 16))).astype(np.float32)
    fc = mxt.sym.FullyConnected(mxt.sym.Variable("data"), num_hidden=4,
                                name="fc")
    out = mxt.sym.Custom(fc, name="softmax", op_type="softmax_t")
    assert out.list_arguments() == ["data", "fc_weight", "fc_bias",
                                    "softmax_label"]
    it = mxt.io.NDArrayIter(x, y.astype(np.float32), batch_size=64)
    mod = mxt.mod.Module(out, label_names=("softmax_label",), context=CPU)
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": 0.5},
            num_epoch=4)
    score = dict(mod.score(it, mxt.metric.Accuracy()))
    assert score["accuracy"] > 0.9, score


def test_custom_refused_inside_a_graph_capture(monkeypatch):
    """Inside a CUDA graph capture the op raises naming its op_type (the
    CPU has no capture, so the probe is patched); the whole step refuses
    a Custom net at its trace and runs it eagerly, naming the op."""
    x = mxt.nd.array(np.ones((2, 2), np.float32), ctx=CPU)
    monkeypatch.setattr(tcustom, "_capturing", lambda ins: True)
    with pytest.raises(mxt.MXNetError, match="sqr_t"):
        mxt.nd.Custom(x, op_type="sqr_t")
    monkeypatch.undo()

    class Net(mxt.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.fc = mxt.gluon.nn.Dense(3)

        def hybrid_forward(self, F, v):
            return F.Custom(self.fc(v), op_type="sqr_t")

    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    net = Net()
    net.initialize(ctx=CPU)
    net.hybridize()
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    step = mxt.gluon.WholeStepCompiler(net, mxt.gluon.loss.L2Loss(), trainer)
    data = mxt.nd.array(_rs().randn(4, 5).astype(np.float32), ctx=CPU)
    label = mxt.nd.array(np.zeros((4, 3), np.float32), ctx=CPU)
    for _ in range(2):      # the first resolves the deferred shapes
        loss = step.step(data, label)
    assert loss.shape == (4,) and not step.active
    assert "Custom" in step.fallback_reason


# -- mx.contrib ---------------------------------------------------------------
def test_contrib_namespaces_match_jax(monkeypatch):
    """``contrib.ndarray``/``symbol``/``autograd`` export the JAX package's
    names; the old autograd sections record; ``LogMetricsCallback`` raises
    ImportError without a writer, as the JAX one does."""
    for mod in ("ndarray", "symbol", "autograd"):
        want = {n for n in dir(getattr(mxj.contrib, mod))
                if not n.startswith("_")}
        got = {n for n in dir(getattr(mxt.contrib, mod))
               if not n.startswith("_")}
        assert want <= got, (mod, want - got)
    assert mxt.nd.contrib.MultiBoxPrior is mxt.contrib.ndarray.MultiBoxPrior
    x = mxt.nd.attach_grad(mxt.nd.array([1.0, 2.0], ctx=CPU))
    with mxt.contrib.autograd.train_section():
        head = (x * x).sum()
    grads = mxt.contrib.autograd.compute_gradient([head])
    assert grads == [None]       # the head is no leaf: nothing to report
    np.testing.assert_allclose(mxt.nd.asnumpy(x.grad), [2.0, 4.0])
    import sys
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError):
        mxt.contrib.tensorboard.LogMetricsCallback("unused")
