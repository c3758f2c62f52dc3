"""Contrib operators (parity: ``mxnet_tpu/ops/contrib.py``): the CTC loss.

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
recursion answers every row.  The other contrib ops are not ported yet
(ROADMAP.md, item 7c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import Arg
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
