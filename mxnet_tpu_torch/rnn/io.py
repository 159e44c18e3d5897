"""Bucketed sequence iterator: the port of `mxnet_tpu/rnn/io.py` (parity
`python/mxnet/rnn/io.py`).

`BucketSentenceIter` groups sentences by length buckets and yields padded
batches with ``bucket_key`` set: the input contract of `BucketingModule`,
which holds one captured training step a bucket on a card. The batches
are made on the current context (the card unless a ``with mx.cpu():``
scope says otherwise). The shuffles draw from Python's and numpy's global
generators, as the reference's do.
"""
from __future__ import annotations

import random as _random

import numpy as _np

from ..io.io import DataIter, DataBatch, DataDesc
from .. import ndarray as nd

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0, unknown_token=None):
    """Encode tokenized sentences to integer ids, building a vocab
    (reference rnn/io.py encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab or unknown_token, f"Unknown token {word}"
                if idx == invalid_label:
                    idx += 1
                if unknown_token and new_vocab is False:
                    word = unknown_token
                    coded.append(vocab[word])
                    continue
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed, padded sentence batches (reference rnn/io.py:77)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lengths = [len(s) for s in sentences]
            counts = _np.bincount(lengths)
            buckets = [i for i, j in enumerate(counts)
                       if j >= batch_size]
            if not buckets:
                buckets = [max(lengths)]
        buckets.sort()

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = _np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [_np.asarray(i, dtype=dtype) for i in self.data]

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            self.provide_data = [DataDesc(data_name,
                                          (batch_size, self.default_bucket_key),
                                          layout=layout)]
            self.provide_label = [DataDesc(label_name,
                                           (batch_size, self.default_bucket_key),
                                           layout=layout)]
        else:
            self.provide_data = [DataDesc(data_name,
                                          (self.default_bucket_key, batch_size),
                                          layout=layout)]
            self.provide_label = [DataDesc(label_name,
                                           (self.default_bucket_key, batch_size),
                                           layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        _random.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch([nd.array(data)], [nd.array(label)], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name, label.shape,
                                                 layout=self.layout)])
