"""BucketSentenceIter (parity: ``mxnet_tpu/rnn/io.py``): per-bucket padded
batches for a ``BucketingModule``.  Its batches are host tensors, as
``NDArrayIter``'s are; the module copies them into its bound inputs on its
device."""
from __future__ import annotations

import random as _pyrandom

import numpy as _np

from ..io import DataIter, DataBatch, DataDesc
from ..ndarray.ndarray import _from_numpy


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0, unknown_token=None):
    """Parity: rnn/io.py encode_sentences."""
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
                assert new_vocab or unknown_token, \
                    f"Unknown token {word}"
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Parity: rnn/io.py BucketSentenceIter."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                _np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
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
        # reshape keeps empty buckets 2-D so reset()'s label shift works
        self.data = [_np.asarray(i, dtype=dtype).reshape(-1, b)
                     for i, b in zip(self.data, buckets)]
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
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(batch_size, self.default_bucket_key),
                layout=layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(batch_size, self.default_bucket_key),
                layout=layout)]
        elif self.major_axis == 1:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(self.default_bucket_key, batch_size),
                layout=layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(self.default_bucket_key, batch_size),
                layout=layout)]
        else:
            raise ValueError("Invalid layout %s: Must by NT (batch major) or "
                             "TN (time major)" % layout)
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(_from_numpy(_np.ascontiguousarray(buck)))
            self.ndlabel.append(_from_numpy(label))

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
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(name=self.data_name,
                                                shape=data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(name=self.label_name,
                                                 shape=label.shape,
                                                 layout=self.layout)])
