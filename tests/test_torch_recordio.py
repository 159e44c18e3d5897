"""The port's `recordio` (`mxnet_tpu_torch/recordio.py`) held to the JAX
package's on the CPU: the same headers and payloads, made from a seed with
numpy, written by either package give byte-identical ``.rec`` and ``.idx``
files, and each package reads the other's (exact equality: the format has
no tolerance). Images go through `pack_img` / `unpack_img` with the codec
both packages find (cv2, else PIL), JPEG and PNG.
"""
import os
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu.recordio as jrec
import mxnet_tpu_torch.recordio as trec


def records(seed=0, n=7):
    """(header, payload) pairs: scalar labels, label arrays (multi-label
    headers) and payloads of every length modulo 4."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 3 == 2:
            label = rng.uniform(0, 9, size=i % 4 + 2).astype(np.float32)
        else:
            label = float(rng.randint(0, 10))
        payload = rng.randint(0, 256, size=5 + 3 * i).astype(np.uint8)
        out.append(((0, label, i, 0), payload.tobytes()))
    return out


def write(mod, folder, recs):
    rec, idx = os.path.join(folder, "d.rec"), os.path.join(folder, "d.idx")
    w = mod.MXIndexedRecordIO(idx, rec, "w")
    for header, payload in recs:
        w.write_idx(header[2], mod.pack(mod.IRHeader(*header), payload))
    w.close()
    return rec, idx


def read_back(mod, rec, idx):
    r = mod.MXIndexedRecordIO(idx, rec, "r")
    out = [mod.unpack(r.read_idx(k)) for k in r.keys]
    r.close()
    return out


def same_unpacked(a, b):
    assert len(a) == len(b)
    for (ha, pa), (hb, pb) in zip(a, b):
        assert pa == pb
        assert (ha.flag, ha.id, ha.id2) == (hb.flag, hb.id, hb.id2)
        np.testing.assert_array_equal(np.asarray(ha.label),
                                      np.asarray(hb.label))


def test_files_are_byte_identical_and_cross_read(tmp_path):
    recs = records()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jfiles = write(jrec, str(tmp_path / "j"), recs)
    tfiles = write(trec, str(tmp_path / "t"), recs)
    for a, b in zip(jfiles, tfiles):
        assert open(a, "rb").read() == open(b, "rb").read()
    want = read_back(jrec, *jfiles)
    same_unpacked(read_back(trec, *jfiles), want)
    same_unpacked(read_back(jrec, *tfiles), want)
    for (header, payload), (h, p) in zip(recs, want):
        assert p == payload
        if np.ndim(header[1]):
            assert h.flag == len(header[1])
            np.testing.assert_array_equal(h.label, header[1])


def test_sequential_read_all_and_offsets(tmp_path):
    recs = records(seed=1)
    rec, idx = write(jrec, str(tmp_path), recs)
    seq = trec.MXRecordIO(rec, "r")
    got = []
    while True:
        r = seq.read()
        if r is None:
            break
        got.append(r)
    seq.close()
    assert got == jrec.read_all_records(rec) == trec.read_all_records(rec)
    offsets = trec.list_record_offsets(rec)
    assert offsets == jrec.list_record_offsets(rec)
    assert offsets == [int(line.split("\t")[1])
                       for line in open(idx).read().splitlines()]


def test_split_records_join(tmp_path):
    """A record split around the magic word (continue flags 1, 2, 3)
    reads as one in both packages."""
    path = str(tmp_path / "split.rec")
    parts = [b"abcde", b"fg", b"hijklmn"]
    with open(path, "wb") as f:
        for flag, part in zip((1, 2, 3), parts):
            f.write(struct.pack("<II", 0xced7230a,
                                (flag << 29) | len(part)))
            f.write(part + b"\0" * ((4 - len(part) % 4) % 4))
        f.write(struct.pack("<II", 0xced7230a, 3) + b"xyz\0")
    want = [b"".join(parts), b"xyz"]
    for mod in (jrec, trec):
        r = mod.MXRecordIO(path, "r")
        assert [r.read(), r.read(), r.read()] == want + [None]
        r.close()
    assert trec.read_all_records(path) == want
    assert trec.list_record_offsets(path) == jrec.list_record_offsets(path)


def test_reader_pickles_and_reopens(tmp_path):
    rec, idx = write(trec, str(tmp_path), records(seed=2))
    r = trec.MXIndexedRecordIO(idx, rec, "r")
    first = r.read_idx(r.keys[3])
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.keys == r.keys and r2.read_idx(r.keys[3]) == first
    r.close()
    r2.close()


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img(tmp_path, fmt):
    """An image record packed by either package is the same bytes, and
    decodes to the same pixels in both (PNG: the image itself)."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, size=(12, 10, 3)).astype(np.uint8)
    header = trec.IRHeader(0, 4.0, 7, 0)
    packed = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert packed == jrec.pack_img(jrec.IRHeader(0, 4.0, 7, 0), img,
                                   quality=90, img_fmt=fmt)
    (ht, it), (hj, ij) = trec.unpack_img(packed), jrec.unpack_img(packed)
    assert ht == hj and ht.label == 4.0 and ht.id == 7
    np.testing.assert_array_equal(it, ij)
    assert it.shape == img.shape
    if fmt == ".png":
        np.testing.assert_array_equal(it, img)
