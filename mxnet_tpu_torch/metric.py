"""Evaluation metrics: the port of `mxnet_tpu/metric.py` (parity
`python/mxnet/metric.py`). Metrics run on the host: each `update` copies
its labels and predictions to numpy (`asnumpy`), as the JAX package's do,
so a metric reads the same values from a card and from the CPU.
"""
from __future__ import annotations

import math

import numpy

from .base import numeric_types

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "check_label_shapes"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for n in (names or [klass.__name__.lower()]):
        _METRIC_REGISTRY[n] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a callable (a `CustomMetric`), an instance, a list
    (a `CompositeEvalMetric`) or a registered name."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise ValueError(f"metric {metric} cannot be created")


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


def _asnp(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else numpy.asarray(x)


class EvalMetric:
    """The base: a running ``sum_metric`` over ``num_inst`` instances."""

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
            label = [label[name] for name in self.label_names
                     if name in label]
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


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

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
            if isinstance(name, str):
                name = [name]
            if isinstance(value, numeric_types):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    """The share of predictions (argmax along ``axis``) equal to the
    label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_np = _asnp(pred_label)
            label_np = _asnp(label)
            if pred_np.ndim > label_np.ndim:
                pred_np = numpy.argmax(pred_np, axis=self.axis)
            pred_np = pred_np.astype("int32").reshape(-1)
            label_np = label_np.astype("int32").reshape(-1)
            check_label_shapes(label_np, pred_np)
            self.sum_metric += (pred_np == label_np).sum()
            self.num_inst += len(pred_np)


@register
class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` highest predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more than 1")
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            if len(pred_label.shape) > 2:
                raise ValueError("Predictions should be no more than 2 dims")
            pred_np = numpy.argsort(_asnp(pred_label).astype("float32"),
                                    axis=1)
            label_np = _asnp(label).astype("int32")
            num_samples = pred_np.shape[0]
            if pred_np.ndim == 1:
                self.sum_metric += (pred_np.reshape(-1)
                                    == label_np.reshape(-1)).sum()
            else:
                num_classes = pred_np.shape[1]
                for j in range(min(num_classes, self.top_k)):
                    self.sum_metric += (
                        pred_np[:, num_classes - 1 - j].reshape(-1)
                        == label_np.reshape(-1)).sum()
            self.num_inst += num_samples


def _binary_counts(label, pred):
    pred_np = _asnp(pred)
    label_np = _asnp(label).astype("int32").reshape(-1)
    pred_lab = numpy.argmax(pred_np, axis=-1).reshape(-1) \
        if pred_np.ndim > 1 else (pred_np > 0.5).astype("int32")
    return (float(((pred_lab == 1) & (label_np == 1)).sum()),
            float(((pred_lab == 1) & (label_np == 0)).sum()),
            float(((pred_lab == 0) & (label_np == 0)).sum()),
            float(((pred_lab == 0) & (label_np == 1)).sum()))


@register
class F1(EvalMetric):
    """The F1 score of binary predictions."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._tp = self._fp = self._fn = 0.0
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            tp, fp, _, fn = _binary_counts(label, pred)
            self._tp += tp
            self._fp += fp
            self._fn += fn
            prec = self._tp / (self._tp + self._fp) \
                if self._tp + self._fp > 0 else 0.0
            rec = self._tp / (self._tp + self._fn) \
                if self._tp + self._fn > 0 else 0.0
            self.sum_metric = 2 * prec * rec / (prec + rec) \
                if prec + rec > 0 else 0.0
            self.num_inst = 1

    def reset(self):
        self._tp = self._fp = self._fn = 0.0
        self.sum_metric = 0.0
        self.num_inst = 0


@register
class MCC(EvalMetric):
    """The Matthews correlation coefficient of binary predictions."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._tp = self._fp = self._tn = self._fn = 0.0
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            tp, fp, tn, fn = _binary_counts(label, pred)
            self._tp += tp
            self._fp += fp
            self._tn += tn
            self._fn += fn
            num = self._tp * self._tn - self._fp * self._fn
            den = math.sqrt((self._tp + self._fp) * (self._tp + self._fn)
                            * (self._tn + self._fp) * (self._tn + self._fn))
            self.sum_metric = num / den if den else 0.0
            self.num_inst = 1

    def reset(self):
        self._tp = self._fp = self._tn = self._fn = 0.0
        self.sum_metric = 0.0
        self.num_inst = 0


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log probability of the labels."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("labels and preds differ in length")
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label_np = _asnp(label).astype("int32").reshape(-1)
            pred_np = _asnp(pred)
            pred_np = pred_np.reshape(-1, pred_np.shape[-1])
            probs = pred_np[numpy.arange(label_np.shape[0]), label_np]
            if self.ignore_label is not None:
                ignore = (label_np == self.ignore_label).astype(pred_np.dtype)
                probs = probs * (1 - ignore) + ignore
                num -= int(ignore.sum())
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label_np.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _as_columns(label, pred):
    label_np, pred_np = _asnp(label), _asnp(pred)
    if label_np.ndim == 1:
        label_np = label_np.reshape(label_np.shape[0], 1)
    if pred_np.ndim == 1:
        pred_np = pred_np.reshape(pred_np.shape[0], 1)
    return label_np, pred_np


@register
class MAE(EvalMetric):
    """Mean absolute error."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np, pred_np = _as_columns(label, pred)
            self.sum_metric += numpy.abs(label_np - pred_np).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    """Mean squared error."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np, pred_np = _as_columns(label, pred)
            self.sum_metric += ((label_np - pred_np) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    """Root of the mean of the batches' mean squared errors."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    """Mean -log of the probability predicted for the label."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _asnp(label).ravel()
            pred_np = _asnp(pred)
            if label_np.shape[0] != pred_np.shape[0]:
                raise ValueError("labels and preds differ in length")
            prob = pred_np[numpy.arange(label_np.shape[0]),
                           numpy.int64(label_np)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label_np.shape[0]


@register
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    update = CrossEntropy.update


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            self.sum_metric += numpy.corrcoef(_asnp(pred).ravel(),
                                              _asnp(label).ravel())[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """The mean of the loss values given as predictions."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            self.sum_metric += _asnp(pred).sum()
            self.num_inst += pred.size


class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays: a value, or (sum, count)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            reval = self._feval(_asnp(label), _asnp(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A `CustomMetric` from a function of numpy arrays."""
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


for _alias, _cls_name in (
        ("acc", "accuracy"), ("top_k_accuracy", "topkaccuracy"),
        ("top_k_acc", "topkaccuracy"), ("ce", "crossentropy"),
        ("nll_loss", "negativeloglikelihood"),
        ("pearsonr", "pearsoncorrelation"),
        ("composite", "compositeevalmetric")):
    _METRIC_REGISTRY[_alias] = _METRIC_REGISTRY[_cls_name]
