"""gluon losses: the port of `mxnet_tpu/gluon/loss.py` (parity
`python/mxnet/gluon/loss.py`). Each loss is a HybridBlock that returns one
value per sample (the mean over every axis but ``batch_axis``); CTCLoss
runs the CTCLoss op (`ops/ctc.py`). Every loss of the JAX file is ported.
"""
from __future__ import annotations

import numpy as _np

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (float, int)):
            raise TypeError("weight must be a number")
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    """The base of the losses."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _mean(self, F, loss):
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L2Loss(Loss):
    """0.5 * (label - pred)^2."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(_reshape_like(F, label, pred) - pred)
        return self._mean(F, _apply_weighting(F, loss, self._weight / 2,
                                              sample_weight))


class L1Loss(Loss):
    """|label - pred|."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(_reshape_like(F, label, pred) - pred)
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy, on logits unless ``from_sigmoid``."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            softrelu = F.Activation(-F.abs(pred), act_type="softrelu")
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + softrelu
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * (
                    softrelu + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] (sparse labels) or -sum(label *
    log softmax(pred))."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label * (log label - pred), pred log-probabilities unless
    ``from_logits`` is False."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


class CTCLoss(Loss):
    """Connectionist temporal classification (Graves et al. 2006): the
    negative log-likelihood of each label under the unnormalized
    activations ``pred`` (``layout`` NTC or TNC), the blank the last
    class, labels padded with -1 (``label_layout`` NT or TN). The optional
    ``pred_lengths`` and ``label_lengths`` are each sample's lengths."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(
                f"Only 'NTC' and 'TNC' layouts are supported. Got: {layout}")
        if label_layout not in ("NT", "TN"):
            raise ValueError("Only 'NT' and 'TN' label layouts are "
                             f"supported. Got: {label_layout}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smoothed L1: quadratic within rho, linear beyond."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(_reshape_like(F, label, pred) - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


class HingeLoss(Loss):
    """max(0, margin - pred * label)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * _reshape_like(F, label, pred))
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


class SquaredHingeLoss(Loss):
    """max(0, margin - pred * label)^2."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(F.relu(self._margin
                               - pred * _reshape_like(F, label, pred)))
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


class LogisticLoss(Loss):
    """log(1 + exp(-pred * label)), labels signed (-1, 1) or binary."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError("label_format can only be signed or binary, "
                             f"recieved {label_format}.")

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))


class TripletLoss(Loss):
    """max(0, margin + |pred - positive|^2 - |pred - negative|^2)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, None)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood, one mean over everything."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(F, target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling_factor = target * F.log(target) - target + \
                0.5 * F.log(2 * target * _np.pi)
            stirling_factor = F.where(target > 1, stirling_factor,
                                      F.zeros_like(stirling_factor))
            loss = loss + stirling_factor
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    """1 - cos(x1, x2) for label 1, max(0, cos(x1, x2) - margin) else."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(F, input1, input2)
        cos_sim = self._cosine_similarity(F, input1, input2)
        label = label.reshape((-1, 1))
        pos = 1 - cos_sim
        neg = F.relu(cos_sim - self._margin)
        loss = F.where(label == 1, pos, neg)
        return self._mean(F, _apply_weighting(F, loss, self._weight,
                                              sample_weight))

    @staticmethod
    def _cosine_similarity(F, x, y, axis=-1):
        x_norm = F.norm(x, axis=axis).reshape((-1, 1))
        y_norm = F.norm(y, axis=axis).reshape((-1, 1))
        x_dot_y = F.sum(x * y, axis=axis).reshape((-1, 1))
        return x_dot_y / F.maximum(x_norm * y_norm, 1e-12)
