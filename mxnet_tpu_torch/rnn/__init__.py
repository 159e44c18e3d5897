"""mx.rnn, the legacy rnn package: the port of `mxnet_tpu/rnn/` (parity
`python/mxnet/rnn/`): `BucketSentenceIter`, `encode_sentences` and the
cell names, which are gluon's cells."""
from .io import BucketSentenceIter, encode_sentences
from ..gluon.rnn import (RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
                         BidirectionalCell, DropoutCell, ZoneoutCell,
                         ResidualCell)

__all__ = ["BucketSentenceIter", "encode_sentences", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell"]
