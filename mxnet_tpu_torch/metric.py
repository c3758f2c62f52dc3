"""Evaluation metrics (parity: python/mxnet/metric.py).

The counterpart of ``mxnet_tpu/metric.py``: Accuracy, TopKAccuracy, F1,
Perplexity, MAE, MSE, RMSE, CrossEntropy, NegativeLogLikelihood,
PearsonCorrelation, Loss, Torch, Caffe, CustomMetric, CompositeEvalMetric,
``np()`` and ``create()``.  They compute on the host, in numpy, from
tensors (copied off the device once per update) or arrays.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .analysis import sanitizer as _san
from .base import MXNetError, Registry

_REG = Registry("metric")


def check_label_shapes(labels, preds, shape=False):
    if shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape[0], preds.shape[0]
    if label_shape != pred_shape:
        raise MXNetError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")


def _as_np(x):
    """A host array; bfloat16 tensors come back as float32."""
    if isinstance(x, torch.Tensor):
        _san.check_sync("metric update")
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


def register(cls):
    _REG.register(cls)
    return cls


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _REG.get(metric)(*args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name) if not isinstance(name, list) else names.extend(name)
            values.append(value) if not isinstance(value, list) else values.extend(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label)
            if pred.ndim > label.ndim:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred)
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(pred)


acc = Accuracy
_REG._map["acc"] = Accuracy


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert top_k > 1, "use Accuracy for top_k=1"
        self.name += f"_{top_k}"

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label).astype("int32")
            assert pred.ndim == 2
            argsorted = _np.argsort(pred, axis=1)
            num_samples = pred.shape[0]
            num_classes = pred.shape[1]
            top_k = min(num_classes, self.top_k)
            for j in range(top_k):
                self.sum_metric += (
                    argsorted[:, num_classes - 1 - j].ravel() == label.ravel()).sum()
            self.num_inst += num_samples


_REG._map["top_k_acc"] = TopKAccuracy
_REG._map["top_k_accuracy"] = TopKAccuracy


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label).ravel()
            pred_label = _np.argmax(pred, axis=1)
            if len(_np.unique(label)) > 2:
                raise MXNetError("F1 currently only supports binary classification.")
            tp = ((pred_label == 1) & (label == 1)).sum()
            fp = ((pred_label == 1) & (label == 0)).sum()
            fn = ((pred_label == 0) & (label == 1)).sum()
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = 2 * precision * recall / (precision + recall) \
                if precision + recall > 0 else 0.0
            self.sum_metric += f1
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(-1).astype("int32")
            pred = pred.reshape(label.shape[0], -1)
            probs = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += _np.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += _np.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


_REG._map["nll_loss"] = NegativeLogLikelihood


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += _np.corrcoef(pred.ravel(), label.ravel())[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of the raw outputs (used with MakeLoss / gluon losses)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += _as_np(pred).sum()
            self.num_inst += _as_np(pred).size if hasattr(pred, "size") else 1


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds, shape=True)
        for pred, label in zip(preds, labels):
            label, pred = _as_np(label), _as_np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy eval function as a metric (parity: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
