"""Contrib operators (parity: ``mxnet_tpu/ops/contrib.py``): the CTC loss,
``fft``/``ifft``, ``quantize``/``dequantize``, ``count_sketch``,
``khatri_rao``, the SSD ops (``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``), the R-CNN ops (``Proposal``/``MultiProposal``,
``PSROIPooling``) and the deformable ops (``DeformableConvolution``,
``DeformablePSROIPooling``).

The detection ops decode, clip, sort and match in torch ops; their greedy
non-maximum suppression, a loop over every box in the JAX package, is
kernel N (``kernels/nms.py``), one launch a call for the whole batch.  The
scores are sorted with ``torch.sort(stable=True)``, as ``jnp.argsort``
breaks ties by index.  The bilinear sampling of the deformable and
position-sensitive ops is ``map_coordinates(order=1)`` as gathers of the
four neighbours with the same weights (``_sample``), so their
gradients are that formula's.

``_contrib_ctc_loss`` (aliases ``ctc_loss``, ``CTCLoss``) has the JAX op's
schema and answers.  The JAX package computes it with optax's
``ctc_loss``, whose forward recursion runs in log space with ``log(0)``
replaced by ``log_epsilon = -1e5``; here the sequences go through
``torch.nn.functional.ctc_loss`` (``reduction="none"``, on ``log_softmax``
of the (T, N, C) activations), and the rows torch cannot answer as optax
does take a port of optax's recursion (``_optax_ctc``) instead:

  * an impossible alignment (fewer frames than labels plus repeats):
    torch gives ``inf``, optax a finite loss near 1e5;
  * a target that holds the blank (``blank_label="first"`` with 0 inside
    the label length, or labels padded in the middle, which optax reads as
    label 0), or an id outside [0, C).

torch's kernel is one launch each way; the recursion is about 13 launches
a frame each way (``chip_smoke.py`` phase 18 (b) times both), so it runs
only when a batch holds such a row.  Finding those rows reads the labels
and lengths: free where they lie on the host, one wait for the card where
they lie there (torch's ``ctc_loss`` itself copies the lengths to the
host).  Inside a CUDA graph capture, which can hold no such copy, the
recursion answers every row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import Arg
from ..kernels import nms as _nms
from .registry import register

LOG_EPSILON = -1e5


def _optax_ctc(logprobs, logit_pad, labels, label_pad, blank):
    """optax's ``ctc_loss_with_forward_probs`` loss on (N, T, C) log-probs,
    (N, T) frame padding, (N, L) labels and their padding (1.0 = padded)."""
    N, T, C = logprobs.shape
    L = labels.shape[1]
    eps = LOG_EPSILON
    labellens = L - label_pad.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype),
                   (0, 1))
    # the recursion's constant terms, out of the loop
    eps_repeat, eps_other = eps * repeat, eps * (1.0 - repeat)
    phi_lp = logprobs[:, :, blank]                              # (N, T)
    # one_hot(labels) . logprobs: an id outside [0, C) emits log 1 = 0
    valid = (labels >= 0) & (labels < C)
    emit = torch.gather(logprobs, 2, labels.clamp(0, C - 1)[:, None, :]
                        .expand(N, T, L))
    emit = torch.where(valid[:, None, :], emit, torch.zeros_like(emit))
    phi = torch.full((N, L + 1), eps, dtype=logprobs.dtype,
                     device=logprobs.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    em = torch.full((N, L), eps, dtype=logprobs.dtype,
                    device=logprobs.device)
    # a padded frame keeps both states (optax's pad * old + (1 - pad) *
    # new, exact for its 0/1 pads and finite scores)
    padded = logit_pad.bool()

    def add_to_phi(ph, score):
        return torch.cat([ph[:, :1], torch.logaddexp(ph[:, 1:], score)],
                         dim=1)

    for t in range(T):
        prev = add_to_phi(phi, em + eps_repeat)
        e_t, lp = emit[:, t], phi_lp[:, t:t + 1]
        next_em = torch.logaddexp(prev[:, :-1] + e_t, em + e_t)
        next_phi = add_to_phi(prev + lp, em + lp + eps_other)
        pad = padded[:, t:t + 1]
        em = torch.where(pad, em, next_em)
        phi = torch.where(pad, phi, next_phi)
    last = add_to_phi(phi, em)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


@register("_contrib_ctc_loss",
          input_names=("data", "label", "data_lengths", "label_lengths"),
          aliases=("ctc_loss", "CTCLoss"),
          args=[Arg("use_data_lengths", bool, False),
                Arg("use_label_lengths", bool, False),
                Arg("blank_label", str, "first")])
def _ctc_loss(p, data, label, data_lengths=None, label_lengths=None):
    """data: (T, N, C) activations (before the softmax); label: (N, L),
    padded with 0 (``blank_label="first"``, blank is channel 0) or -1
    (``"last"``, blank is channel C-1); the lengths are read when their
    ``use_*`` flag is set.  Returns the (N,) losses."""
    if (p["use_label_lengths"] and not p["use_data_lengths"]
            and label_lengths is None):
        # a Symbol binds the inputs its flags ask for in order, so with
        # only label lengths the third input is those
        data_lengths, label_lengths = None, data_lengths
    T, N, C = data.shape
    if data.device.type == "meta":
        return torch.empty((N,), dtype=data.dtype, device="meta")
    dev = data.device
    # the labels and lengths stay where they lie until the odd rows are
    # known (on the host, finding them needs no wait for the card)
    labels = torch.as_tensor(label).long()
    Lmax = labels.shape[1]
    in_lens = torch.as_tensor(data_lengths) \
        if p["use_data_lengths"] and data_lengths is not None else None
    first = p["blank_label"] == "first"
    blank = 0 if first else C - 1
    if p["use_label_lengths"] and label_lengths is not None:
        steps = torch.arange(Lmax, device=labels.device)[None, :]
        lab_valid = steps < label_lengths.to(labels.device).long()[:, None]
    else:
        lab_valid = labels > 0 if first else labels >= 0
    lab = torch.where(lab_valid, labels, torch.zeros_like(labels))
    tgt_lens = Lmax - (~lab_valid).sum(dim=1)
    # rows torch's kernel cannot answer as optax does, found where the
    # labels lie: the blank or an id outside [0, C) inside the target
    # (labels padded in the middle included), or too few frames
    in_target = torch.arange(Lmax, device=lab.device)[None, :] \
        < tgt_lens[:, None]
    repeats = ((lab[:, 1:] == lab[:, :-1]) & in_target[:, 1:]).sum(dim=1)
    # the frames optax reads: those before the length (a fraction counts)
    frames = torch.full((N,), T, dtype=torch.long, device=lab.device) \
        if in_lens is None else \
        in_lens.to(lab.device).clamp(0, T).ceil().long()
    odd = (((lab == blank) | (lab < 0) | (lab >= C)) & in_target).any(dim=1) \
        | (frames < tgt_lens + repeats)
    odd, lab, lab_valid = odd.to(dev), lab.to(dev), lab_valid.to(dev)
    tgt_lens, frames = tgt_lens.to(dev), frames.to(dev)
    logprobs = torch.log_softmax(data, dim=-1)                  # (T, N, C)
    frame_pad = (torch.arange(T, device=dev)[None, :]
                 >= in_lens.to(dev)[:, None]).to(data.dtype) \
        if in_lens is not None else torch.zeros((N, T), dtype=data.dtype,
                                                device=dev)

    def recursion():
        return _optax_ctc(logprobs.transpose(0, 1), frame_pad, lab,
                          (~lab_valid).to(data.dtype), blank)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        # torch's ctc_loss copies the lengths to the host, which a CUDA
        # graph cannot hold: the recursion answers every row
        return recursion()
    # the odd rows go to torch as empty targets, their results replaced
    loss = F.ctc_loss(logprobs, lab.clamp(0, C - 1), frames,
                      torch.where(odd, torch.zeros_like(tgt_lens), tgt_lens),
                      blank=blank, reduction="none", zero_infinity=True)
    if not bool(odd.any()):
        return loss
    return torch.where(odd, recursion().to(loss.dtype), loss)


# ---------------------------------------------------------------------------
# fft, quantization, count sketch, Khatri-Rao
# ---------------------------------------------------------------------------
def _fft_dtype(x):
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


@register("_contrib_fft", input_names=("data",), aliases=("fft",),
          args=[Arg("compute_size", int, 128)])
def _fft(p, x):
    """The FFT over the last axis, real and imaginary parts interleaved:
    (..., n) -> (..., 2n)."""
    out = torch.view_as_real(torch.fft.fft(_fft_dtype(x), dim=-1))
    return out.reshape(x.shape[:-1] + (2 * x.shape[-1],)).to(x.dtype)


@register("_contrib_ifft", input_names=("data",), aliases=("ifft",),
          args=[Arg("compute_size", int, 128)])
def _ifft(p, x):
    """The inverse of ``fft``'s layout, real part, scaled by n (MXNet's
    unnormalized inverse): (..., 2n) -> (..., n)."""
    n = x.shape[-1] // 2
    comp = _fft_dtype(x).reshape(x.shape[:-1] + (n, 2))
    z = torch.complex(comp[..., 0], comp[..., 1])
    return torch.fft.ifft(z, dim=-1).real.to(x.dtype) * n


def _qrange(out_type):
    return (0.0, 255.0, torch.uint8) if out_type == "uint8" else \
        (-127.0, 127.0, torch.int8)


@register("_contrib_quantize", input_names=("data", "min_range", "max_range"),
          num_outputs=3, differentiable=False,
          args=[Arg("out_type", str, "uint8")])
def _quantize(p, data, min_range, max_range):
    """Affine quantization to uint8 or int8, rounding half to even as
    ``jnp.round`` does; returns (q, min_range, max_range)."""
    qmin, qmax, dt = _qrange(p["out_type"])
    scale = (qmax - qmin) / (max_range - min_range).clamp_min(1e-8)
    q = torch.clamp(torch.round((data - min_range) * scale + qmin),
                    qmin, qmax)
    return q.to(dt), min_range, max_range


@register("_contrib_dequantize",
          input_names=("data", "min_range", "max_range"),
          differentiable=False, args=[Arg("out_type", str, "float32")])
def _dequantize(p, data, min_range, max_range):
    qmin, qmax = (0.0, 255.0) if data.dtype == torch.uint8 else \
        (-127.0, 127.0)
    scale = (max_range - min_range) / (qmax - qmin)
    return (data.to(torch.float32) - qmin) * scale + min_range


@register("_contrib_count_sketch", input_names=("data", "h", "s"),
          args=[Arg("out_dim", int, required=True),
                Arg("processing_batch_size", int, 32)])
def _count_sketch(p, data, h, s):
    """out[:, h[k]] += data[:, k] * s[k]: repeated buckets add up."""
    n, d = data.shape
    hh = h.reshape(-1).to(torch.int64)[:d]
    ss = s.reshape(-1)[:d]
    out = torch.zeros((n, p["out_dim"]), dtype=data.dtype, device=data.device)
    return out.index_add(1, hh, data * ss[None, :])


@register("khatri_rao", input_names=("args",), variadic=True)
def _khatri_rao(p, *mats):
    """Column-wise Khatri-Rao product: (r_i, k) inputs -> (prod r_i, k)."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, m.shape[1])
    return out


# ---------------------------------------------------------------------------
# SSD: MultiBoxPrior, MultiBoxTarget, MultiBoxDetection
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxPrior", input_names=("data",),
          aliases=("MultiBoxPrior",), differentiable=False,
          args=[Arg("sizes", "floats", (1.0,)), Arg("ratios", "floats", (1.0,)),
                Arg("clip", bool, False), Arg("steps", "floats", (-1.0, -1.0)),
                Arg("offsets", "floats", (0.5, 0.5))])
def _multibox_prior(p, data):
    """Anchors of a (N, C, H, W) feature map: (1, H*W*A, 4) corners in
    [0, 1], A = len(sizes) + len(ratios) - 1 per position ((size, size) for
    each size, then sizes[0] at each further ratio).  Computed in float64,
    as the JAX op is, and returned in float32 (the JAX op returns float64,
    ROADMAP.md §3)."""
    H, W = data.shape[2], data.shape[3]
    sizes = [float(v) for v in p["sizes"]]
    ratios = [float(v) for v in p["ratios"]]
    whs = [(v, v) for v in sizes] + [
        (sizes[0] * r ** 0.5, sizes[0] / r ** 0.5) for r in ratios[1:]]
    A = len(whs)
    if data.device.type == "meta":
        return torch.empty((1, H * W * A, 4), device="meta")
    step_y, step_x = p["steps"]
    step_y = 1.0 / H if step_y <= 0 else step_y
    step_x = 1.0 / W if step_x <= 0 else step_x
    off_y, off_x = p["offsets"]
    f64 = dict(dtype=torch.float64, device=data.device)
    cy = (torch.arange(H, **f64) + off_y) * step_y
    cx = (torch.arange(W, **f64) + off_x) * step_x
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), -1).reshape(-1, 2)
    wh = torch.tensor(whs, **f64).repeat(H * W, 1)
    centers = cyx.repeat_interleave(A, dim=0)
    out = torch.stack([centers[:, 1] - wh[:, 0] / 2,
                       centers[:, 0] - wh[:, 1] / 2,
                       centers[:, 1] + wh[:, 0] / 2,
                       centers[:, 0] + wh[:, 1] / 2], dim=-1)
    if p["clip"]:
        out = out.clamp(0.0, 1.0)
    return out[None].to(torch.float32)


def _last_write(index, values, size):
    """(hit, winner, value): for each of ``size`` slots, whether any row
    of ``index`` (B, M) names it, which row names it last and that row's
    ``values`` entry: ``zeros(size).at[index].set(values)`` with the last
    duplicate winning, as JAX's scatter gives it on the CPU, deterministic
    on every device."""
    B, M = index.shape
    rows = torch.arange(M, device=index.device)
    hits = index[:, :, None] == torch.arange(size, device=index.device)
    last = torch.where(hits, rows[None, :, None],
                       torch.full_like(rows, -1)[None, :, None]).amax(dim=1)
    hit = last >= 0
    winner = last.clamp_min(0)
    return hit, winner, torch.gather(values, 1, winner)


@register("_contrib_MultiBoxTarget",
          input_names=("anchor", "label", "cls_pred"),
          aliases=("MultiBoxTarget",), num_outputs=3, differentiable=False,
          args=[Arg("overlap_threshold", float, 0.5),
                Arg("ignore_label", float, -1.0),
                Arg("negative_mining_ratio", float, -1.0),
                Arg("negative_mining_thresh", float, 0.5),
                Arg("minimum_negative_samples", int, 0),
                Arg("variances", "floats", (0.1, 0.1, 0.2, 0.2))])
def _multibox_target(p, anchor, label, cls_pred):
    """Anchor-to-ground-truth matching and regression targets, as the JAX
    op: anchor (1, A, 4), label (N, M, 5) [cls, x1, y1, x2, y2] (cls < 0 a
    padded row), cls_pred (N, C+1, A) (unread).  Returns (loc_target (N,
    A*4), loc_mask (N, A*4), cls_target (N, A)).  An anchor matches the
    ground truth of its best IoU above ``overlap_threshold``, and each
    ground truth forces a match at its own best anchor; where two rows
    name one best anchor (two boxes, or a padded row, whose IoUs are all
    -1, naming anchor 0) the last row wins, as JAX's scatter does on the
    CPU.  Like the JAX op it reads neither the negative-mining arguments
    nor ``ignore_label``: every unmatched anchor is class 0 (ROADMAP.md
    §3)."""
    N, M = label.shape[0], label.shape[1]
    A = anchor.shape[1]
    dt = torch.promote_types(anchor.dtype, label.dtype)
    if anchor.device.type == "meta":
        return (torch.empty((N, A * 4), dtype=dt, device="meta"),
                torch.empty((N, A * 4), dtype=dt, device="meta"),
                torch.empty((N, A), dtype=label.dtype, device="meta"))
    anchors = anchor[0].to(dt)
    lab = label.to(dt)
    vx, vy, vw, vh = p["variances"]
    valid = label[:, :, 0] >= 0                                   # (N, M)
    gt = lab[:, :, 1:5]
    ious = _nms.pair_iou(anchors[None, :, None, :], gt[:, None, :, :],
                         pixel=False)                             # (N, A, M)
    ious = torch.where(valid[:, None, :], ious, torch.full_like(ious, -1.0))
    best_iou, best_gt = ious.amax(dim=2), ious.argmax(dim=2)
    matched = best_iou > p["overlap_threshold"]
    best_anchor = ious.argmax(dim=1)                              # (N, M)
    hit, forced_gt, forced_valid = _last_write(best_anchor, valid, A)
    forced = hit & forced_valid
    use_gt = torch.where(forced, forced_gt, best_gt)
    matched = matched | forced
    g = torch.gather(gt, 1, use_gt[:, :, None].expand(N, A, 4))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = (g[..., 2] - g[..., 0]).clamp_min(1e-8)
    gh = (g[..., 3] - g[..., 1]).clamp_min(1e-8)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    tx = (gcx - acx) / aw.clamp_min(1e-8) / vx
    ty = (gcy - acy) / ah.clamp_min(1e-8) / vy
    tw = torch.log(gw / aw.clamp_min(1e-8)) / vw
    th = torch.log(gh / ah.clamp_min(1e-8)) / vh
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)
    m4 = matched[:, :, None]
    loc_t = torch.where(m4, loc_t, torch.zeros_like(loc_t)).reshape(N, -1)
    loc_m = m4.expand(N, A, 4).to(dt).reshape(N, -1)
    cls_g = torch.gather(label[:, :, 0], 1, use_gt) + 1
    cls_t = torch.where(matched, cls_g, torch.zeros_like(cls_g))
    return loc_t, loc_m, cls_t


def detection_candidates(p, cls_prob, loc_pred, anchor):
    """MultiBoxDetection before its suppression: the decoded (and clipped)
    boxes, class ids (-1 below ``threshold``) and scores, each sample's
    sorted by descending score (ties by index)."""
    N, A = cls_prob.shape[0], anchor.shape[1]
    anchors = anchor[0]
    vx, vy, vw, vh = p["variances"]
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    loc = loc_pred.reshape(N, A, 4)
    cx = loc[..., 0] * vx * aw + acx
    cy = loc[..., 1] * vy * ah + acy
    w = torch.exp(loc[..., 2] * vw) * aw
    h = torch.exp(loc[..., 3] * vh) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if p["clip"]:
        boxes = boxes.clamp(0.0, 1.0)
    bg = p["background_id"]
    scores = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    score, cls_id = scores.amax(dim=1), scores.argmax(dim=1)
    cls_id = torch.where(score > p["threshold"], cls_id.to(torch.float32),
                         torch.full_like(score, -1.0, dtype=torch.float32))
    order = torch.sort(-score, dim=1, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[:, :, None].expand(N, A, 4))
    cls_s = torch.gather(cls_id, 1, order)
    score_s = torch.gather(score, 1, order)
    return boxes_s, cls_s, score_s


@register("_contrib_MultiBoxDetection",
          input_names=("cls_prob", "loc_pred", "anchor"),
          aliases=("MultiBoxDetection",), differentiable=False,
          args=[Arg("clip", bool, True), Arg("threshold", float, 0.01),
                Arg("background_id", int, 0), Arg("nms_threshold", float, 0.5),
                Arg("force_suppress", bool, False),
                Arg("variances", "floats", (0.1, 0.1, 0.2, 0.2)),
                Arg("nms_topk", int, -1)])
def _multibox_detection(p, cls_prob, loc_pred, anchor):
    """Decode and suppress, as the JAX op: (N, A, 6) rows [class id, score,
    x1, y1, x2, y2] in descending score order, a suppressed or
    below-threshold row's class id -1.  One launch of kernel N for the
    batch (per class unless ``force_suppress``)."""
    N, A = cls_prob.shape[0], anchor.shape[1]
    dt = torch.promote_types(torch.promote_types(cls_prob.dtype,
                                                 loc_pred.dtype), anchor.dtype)
    if cls_prob.device.type == "meta":
        return torch.empty((N, A, 6), dtype=dt, device="meta")
    boxes_s, cls_s, score_s = detection_candidates(p, cls_prob, loc_pred,
                                                   anchor)
    alive = _nms.nms_keep(boxes_s.to(torch.float32).contiguous(),
                          cls_s.contiguous(), cls_s >= 0,
                          p["nms_threshold"], pixel=False,
                          class_aware=not p["force_suppress"])
    cls_out = torch.where(alive, cls_s, torch.full_like(cls_s, -1.0))
    return torch.cat([cls_out[..., None].to(dt), score_s[..., None].to(dt),
                      boxes_s.to(dt)], dim=-1)


# ---------------------------------------------------------------------------
# R-CNN: Proposal, PSROIPooling
# ---------------------------------------------------------------------------
def _gen_base_anchors(scales, ratios, base_size):
    """Anchors centred at ((base-1)/2, (base-1)/2), corners in pixels;
    Python's ``round`` (half to even), as the JAX op has it."""
    anchors = []
    cx = cy = (base_size - 1) / 2.0
    area = float(base_size * base_size)
    for r in ratios:
        w = round((area / r) ** 0.5)
        h = round(w * r)
        for s in scales:
            ws, hs = w * s, h * s
            anchors.append([cx - (ws - 1) / 2, cy - (hs - 1) / 2,
                            cx + (ws - 1) / 2, cy + (hs - 1) / 2])
    return anchors


def proposal_candidates(p, cls_prob, bbox_pred, im_info):
    """Proposal before its suppression: each image's ``rpn_pre_nms_top_n``
    best decoded, clipped boxes (pixels) and foreground scores (-1 for a
    box under the minimum size), by descending score (ties by index)."""
    N, _, H, W = cls_prob.shape
    stride = p["feature_stride"]
    base = _gen_base_anchors(p["scales"], p["ratios"], stride)
    A = len(base)
    pre_n = min(p["rpn_pre_nms_top_n"], H * W * A)
    dev = cls_prob.device
    f32 = dict(dtype=torch.float32, device=dev)
    sy, sx = torch.meshgrid(torch.arange(H, device=dev) * stride,
                            torch.arange(W, device=dev) * stride,
                            indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 4)
    anchors = (torch.tensor(base, **f32)[None] + shifts[:, None]).reshape(-1, 4)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    d = bbox_pred.permute(0, 2, 3, 1).reshape(N, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    zero = torch.zeros((), **f32)
    xmax = (im_info[:, 1] - 1)[:, None]
    ymax = (im_info[:, 0] - 1)[:, None]
    x1 = torch.minimum(torch.maximum(cx - 0.5 * (w - 1), zero), xmax)
    y1 = torch.minimum(torch.maximum(cy - 0.5 * (h - 1), zero), ymax)
    x2 = torch.minimum(torch.maximum(cx + 0.5 * (w - 1), zero), xmax)
    y2 = torch.minimum(torch.maximum(cy + 0.5 * (h - 1), zero), ymax)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    min_size = (p["rpn_min_size"] * im_info[:, 2])[:, None]
    valid = ((x2 - x1 + 1) >= min_size) & ((y2 - y1 + 1) >= min_size)
    fg = torch.where(valid, fg, torch.full_like(fg, -1.0))
    order = torch.sort(-fg, dim=1, stable=True).indices[:, :pre_n]
    boxes_s = torch.gather(boxes, 1, order[:, :, None].expand(N, pre_n, 4))
    score_s = torch.gather(fg, 1, order)
    return boxes_s, score_s


@register("_contrib_Proposal", input_names=("cls_prob", "bbox_pred", "im_info"),
          aliases=("Proposal", "_contrib_MultiProposal", "MultiProposal"),
          differentiable=False,
          args=[Arg("rpn_pre_nms_top_n", int, 6000),
                Arg("rpn_post_nms_top_n", int, 300),
                Arg("threshold", float, 0.7),
                Arg("rpn_min_size", int, 16),
                Arg("scales", "floats", (4.0, 8.0, 16.0, 32.0)),
                Arg("ratios", "floats", (0.5, 1.0, 2.0)),
                Arg("feature_stride", int, 16),
                Arg("output_score", bool, False),
                Arg("iou_loss", bool, False)])
def _proposal(p, cls_prob, bbox_pred, im_info):
    """RPN proposals, as the JAX op: decode each anchor's deltas, clip to
    the image, drop boxes under ``rpn_min_size * im_info[2]``, keep the
    ``rpn_pre_nms_top_n`` best, suppress (kernel N, pixel IoU, one launch
    for the batch), keep the ``rpn_post_nms_top_n`` first survivors.
    Output (N * post_n, 5) [batch index, x1, y1, x2, y2], slots past the
    survivors padded with the best ROI and score 0; with ``output_score``
    also the (N * post_n, 1) scores."""
    N, post_n = cls_prob.shape[0], p["rpn_post_nms_top_n"]
    dev = cls_prob.device
    if dev.type == "meta":
        rois = torch.empty((N * post_n, 5), device="meta")
        return (rois, torch.empty((N * post_n, 1), device="meta")) \
            if p["output_score"] else rois
    boxes_s, score_s = proposal_candidates(p, cls_prob, bbox_pred, im_info)
    pre_n = boxes_s.shape[1]
    alive = _nms.nms_keep(boxes_s.to(torch.float32).contiguous(), None,
                          score_s > -1.0, p["threshold"], pixel=True)
    idx = torch.arange(pre_n, device=dev)
    rank = torch.where(alive, idx, torch.full_like(idx, pre_n))
    keep = torch.sort(rank, dim=1, stable=True).indices[:, :post_n]
    kept_boxes = torch.gather(boxes_s, 1,
                              keep[:, :, None].expand(N, keep.shape[1], 4))
    kept_scores = torch.where(torch.gather(alive, 1, keep),
                              torch.gather(score_s, 1, keep),
                              torch.zeros((), dtype=score_s.dtype, device=dev))
    pad = (torch.arange(post_n, device=dev)[None, :]
           < alive.sum(dim=1, keepdim=True))[:, :, None]
    kept_boxes = torch.where(pad, kept_boxes, kept_boxes[:, :1])
    batch_idx = torch.arange(N, dtype=torch.float32,
                             device=dev).repeat_interleave(post_n)
    rois = torch.cat([batch_idx[:, None],
                      kept_boxes.reshape(-1, 4).to(torch.float32)], dim=1)
    if p["output_score"]:
        return rois, kept_scores.reshape(-1, 1)
    return rois


def _sample(planes, plane, y, x, constant):
    """``map_coordinates(planes[plane], [y, x], order=1)`` for planes (P, H,
    W) at coordinates y, x, ``plane`` an integer tensor broadcast against
    them: the four neighbours' values times the products of their weights
    (``1 - frac`` and ``frac``, in the coordinates' dtype), added in the
    order (y0, x0), (y0, x1), (y1, x0), (y1, x1); ``constant`` gives 0 to a
    neighbour outside the map (``mode="constant"``), else the edge value
    (``mode="nearest"``).  Returns the planes' dtype, as map_coordinates
    does.  Gathers single elements, so no plane is copied."""
    _, H, W = planes.shape
    flat = planes.reshape(-1)
    y0f, x0f = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0f, x - x0f
    y0, x0 = y0f.long(), x0f.long()
    base = plane * (H * W)
    out = None
    for iy, wy in ((y0, 1 - wy1), (y0 + 1, wy1)):
        for ix, wx in ((x0, 1 - wx1), (x0 + 1, wx1)):
            v = flat[base + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)]
            if constant:
                ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
                v = torch.where(ok, v, torch.zeros((), dtype=v.dtype,
                                                   device=v.device))
            term = (wy * wx) * v
            out = term if out is None else out + term
    return out.to(planes.dtype)


@register("_contrib_PSROIPooling", input_names=("data", "rois"),
          aliases=("PSROIPooling",),
          args=[Arg("spatial_scale", float, required=True),
                Arg("output_dim", int, required=True),
                Arg("pooled_size", int, required=True),
                Arg("group_size", int, 0)])
def _psroi_pooling(p, data, rois):
    """Position-sensitive ROI pooling (R-FCN), as the JAX op: output (R, D,
    k, k), cell (i, j) of output channel d the mean of 4x4 bilinear samples
    (edge-clamped) of score map (d*gs + gh)*gs + gw, (gh, gw) the cell's
    group.  The sample positions are float64, as under the JAX package's
    64-bit mode."""
    k, D = p["pooled_size"], p["output_dim"]
    gs = p["group_size"] or k
    N, C, H, W = data.shape
    R = rois.shape[0]
    if data.device.type == "meta":
        return torch.empty((R, D, k, k), dtype=data.dtype, device="meta")
    S = 4
    dev = data.device
    r = rois.to(data.dtype)
    b = r[:, 0].long()
    x1, y1 = r[:, 1] * p["spatial_scale"], r[:, 2] * p["spatial_scale"]
    x2, y2 = r[:, 3] * p["spatial_scale"], r[:, 4] * p["spatial_scale"]
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    frac = (torch.arange(k, dtype=torch.float64, device=dev)[:, None]
            + (torch.arange(S, dtype=torch.float64, device=dev)[None, :]
               + 0.5) / S)                                         # (k, S)
    ys = (y1[:, None, None] + frac[None] * (rh / k)[:, None, None]
          ).clamp(0, H - 1)                                        # (R, k, S)
    xs = (x1[:, None, None] + frac[None] * (rw / k)[:, None, None]
          ).clamp(0, W - 1)
    cells = torch.arange(k, device=dev)
    grp = cells * gs // k
    ch = ((torch.arange(D, device=dev)[:, None, None] * gs
           + grp[None, :, None]) * gs + grp[None, None, :])        # (D, k, k)
    plane = (b[:, None, None, None] * C + ch[None])[..., None]  # (R, D, k, k, 1)
    gy = ys[:, None, :, None, :, None].expand(R, D, k, k, S, S)
    gx = xs[:, None, None, :, None, :].expand(R, D, k, k, S, S)
    vals = _sample(data.reshape(N * C, H, W), plane,
                   gy.reshape(R, D, k, k, S * S),
                   gx.reshape(R, D, k, k, S * S), False)
    return vals.mean(dim=-1)


# ---------------------------------------------------------------------------
# Deformable ops
# ---------------------------------------------------------------------------
@register("_contrib_DeformableConvolution",
          input_names=("data", "offset", "weight", "bias"),
          aliases=("DeformableConvolution",),
          args=[Arg("kernel", "shape", required=True),
                Arg("stride", "shape", (1, 1)), Arg("dilate", "shape", (1, 1)),
                Arg("pad", "shape", (0, 0)), Arg("num_filter", int, required=True),
                Arg("num_group", int, 1), Arg("num_deformable_group", int, 1),
                Arg("no_bias", bool, False)])
def _deformable_conv(p, data, offset, weight, bias=None):
    """Deformable convolution v1, as the JAX op: each output position's
    kernel taps move by the offsets (channel 2*(i*kw + j) is y, +1 is x,
    per deformable group), the data is sampled there bilinearly with zeros
    outside (``mode="constant"``), and the columns contract with the
    weight per group."""
    kh, kw = p["kernel"]
    sh, sw = p["stride"] or (1, 1)
    dh, dw = p["dilate"] or (1, 1)
    ph, pw = p["pad"] or (0, 0)
    N, C, H, W = data.shape
    G = p["num_deformable_group"]
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    F_ = p["num_filter"]
    if data.device.type == "meta":
        return torch.empty((N, F_, Ho, Wo), dtype=data.dtype, device="meta")
    dev = data.device
    off = offset.reshape(N, G, kh * kw, 2, Ho, Wo)
    oy = off[:, :, :, 0].reshape(N, G, kh, kw, Ho, Wo)
    ox = off[:, :, :, 1].reshape(N, G, kh, kw, Ho, Wo)
    base_y = (torch.arange(Ho, device=dev)[None, None, :, None] * sh - ph
              + torch.arange(kh, device=dev)[:, None, None, None] * dh)
    base_x = (torch.arange(Wo, device=dev)[None, None, None, :] * sw - pw
              + torch.arange(kw, device=dev)[None, :, None, None] * dw)
    yy = (base_y + oy).reshape(N, G, 1, -1)             # (N, G, 1, kh*kw*Ho*Wo)
    xx = (base_x + ox).reshape(N, G, 1, -1)
    plane = torch.arange(N * C, device=dev).reshape(N, G, C // G, 1)
    cols = _sample(data.reshape(N * C, H, W), plane, yy, xx, True)
    ng = p["num_group"]
    Cg, Fg = C // ng, F_ // ng
    cols = cols.reshape(N, ng, Cg, kh, kw, Ho, Wo)
    wgt = weight.reshape(ng, Fg, Cg, kh, kw)
    out = torch.einsum("ngcijhw,gfcij->ngfhw", cols, wgt)
    out = out.reshape(N, F_, Ho, Wo)
    if not p["no_bias"] and bias is not None:
        out = out + bias[None, :, None, None]
    return out


@register("_contrib_DeformablePSROIPooling",
          input_names=("data", "rois", "trans"),
          aliases=("DeformablePSROIPooling",),
          args=[Arg("spatial_scale", float, required=True),
                Arg("output_dim", int, required=True),
                Arg("group_size", int, required=True),
                Arg("pooled_size", int, required=True),
                Arg("part_size", int, 0),
                Arg("sample_per_part", int, 4),
                Arg("trans_std", float, 0.0),
                Arg("no_trans", bool, False)])
def _deformable_psroi_pooling(p, data, rois, trans=None):
    """Deformable position-sensitive ROI pooling, as the JAX op: each
    cell's S x S samples (at sub-bin left edges) shift by the learned
    offset trans[cls*2 (+1), part_h, part_w] * trans_std * the ROI's size;
    samples outside the map are left out of the cell's mean, the rest are
    bilinear over the edge-clamped map.  Differentiable in data and
    trans."""
    k, D = p["pooled_size"], p["output_dim"]
    gs = p["group_size"] or k
    ps = p["part_size"] or k
    S = p["sample_per_part"]
    scale = p["spatial_scale"]
    no_trans = p["no_trans"] or trans is None
    N, C, H, W = data.shape
    R = rois.shape[0]
    if data.device.type == "meta":
        return torch.empty((R, D, k, k), dtype=data.dtype, device="meta")
    dev, dt = data.device, data.dtype
    ncls = 1 if no_trans else trans.shape[1] // 2
    per_cls = D // ncls
    b = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * scale - 0.5
    y1 = torch.round(rois[:, 2]) * scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bw, bh = rw / k, rh / k
    sub_w, sub_h = bw / S, bh / S
    cells = torch.arange(k, device=dev)
    d_idx = torch.arange(D, device=dev)
    if no_trans:
        dx = dy = torch.zeros((R, D, k, k), dtype=dt, device=dev)
    else:
        part = cells * ps // k
        cls = d_idx // per_cls
        tr_x = trans[:, (cls * 2)[:, None, None], part[None, :, None],
                     part[None, None, :]]                          # (R, D, k, k)
        tr_y = trans[:, (cls * 2 + 1)[:, None, None], part[None, :, None],
                     part[None, None, :]]
        dx = tr_x * p["trans_std"] * rw[:, None, None, None]
        dy = tr_y * p["trans_std"] * rh[:, None, None, None]
    ws = cells[None, None, None, :] * bw[:, None, None, None] \
        + x1[:, None, None, None] + dx                             # (R, D, k, k)
    hs = cells[None, None, :, None] * bh[:, None, None, None] \
        + y1[:, None, None, None] + dy
    steps = torch.arange(S, device=dev)
    sx = ws[..., None] + steps * sub_w[:, None, None, None, None]  # (..., S)
    sy = hs[..., None] + steps * sub_h[:, None, None, None, None]
    gy = sy[..., :, None].expand(sy.shape + (S,)).reshape(R, D, k, k, S * S)
    gx = sx[..., None, :].expand(sx.shape[:-1] + (S, S)).reshape(
        R, D, k, k, S * S)
    valid = (gx > -0.5) & (gx < W - 0.5) & (gy > -0.5) & (gy < H - 0.5)
    grp = cells * gs // k
    ch = ((d_idx[:, None, None] * gs + grp[None, :, None]) * gs
          + grp[None, None, :])                                    # (D, k, k)
    plane = (b[:, None, None, None] * C + ch[None])[..., None]
    vals = _sample(data.reshape(N * C, H, W), plane, gy.clamp(0, H - 1),
                   gx.clamp(0, W - 1), False)
    cnt = valid.sum(dim=-1).clamp_min(1)
    return torch.where(valid, vals, torch.zeros((), dtype=dt, device=dev)
                       ).sum(dim=-1) / cnt
