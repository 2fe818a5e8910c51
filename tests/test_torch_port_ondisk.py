"""The port's on-disk readers against the JAX package's on the same tiny
files, written here in each dataset's layout (``tests/test_ondisk.py``'s
files, plus ogbn-mag's paper graph and ogbg-code2): every array equal,
dtypes included. Each reader gets its own copy of the files, so neither
reads the other's ``.npy`` parse cache. The port's native CSV parse
(``egc_tpu_torch.native``) against ``egc_tpu.native``'s on generated CSV
text: bit for bit."""

import gzip
import pickle

import numpy as np
import pytest
import torch

from egc_tpu import native as jnative
from egc_tpu.data import ondisk as jod

from egc_tpu_torch import native as tnative
from egc_tpu_torch.data import ondisk as tod


def write_csv_gz(path, arr, fmt="%d"):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        np.savetxt(f, np.asarray(arr), delimiter=",", fmt=fmt)


def assert_same(got, ref, where="root"):
    """Equal nested dicts / lists of arrays, strings and numbers."""
    assert type(got) is type(ref) or (
        isinstance(got, np.ndarray) and isinstance(ref, np.ndarray)), where
    if isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            assert_same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref, err_msg=where)
        assert got.dtype == ref.dtype, where
    else:
        assert got == ref, where


def both_roots(tmp_path, write):
    """The same files under two roots: (port's, JAX's)."""
    roots = tmp_path / "port", tmp_path / "jax"
    for root in roots:
        write(root)
    return roots


def _ogbg_common(root, sizes, feats):
    """num-node-list, num-edge-list, edge and node-feat of graphs with
    ``sizes`` (nodes, edges) each, local edge ids."""
    rng = np.random.default_rng(0)
    write_csv_gz(root / "raw" / "num-node-list.csv.gz",
                 [[n] for n, _ in sizes])
    write_csv_gz(root / "raw" / "num-edge-list.csv.gz",
                 [[e] for _, e in sizes])
    edges = np.concatenate([rng.integers(0, n, size=(e, 2))
                            for n, e in sizes])
    write_csv_gz(root / "raw" / "edge.csv.gz", edges)
    write_csv_gz(root / "raw" / "node-feat.csv.gz", feats)


def _splits(d, train, valid, test):
    for name, idx in (("train", train), ("valid", valid), ("test", test)):
        write_csv_gz(d / f"{name}.csv.gz", np.asarray(idx).reshape(-1, 1))


def test_load_ogbn_mag_homogeneous_equals_jax(tmp_path):
    n = 9

    def write(root):
        raw = root / "ogbn_mag" / "raw"
        write_csv_gz(raw / "node-feat" / "paper" / "node-feat.csv.gz",
                     np.random.default_rng(2).normal(size=(n, 5)),
                     fmt="%.7g")
        write_csv_gz(raw / "node-label" / "paper" / "node-label.csv.gz",
                     (np.arange(n) % 4).reshape(-1, 1))
        write_csv_gz(raw / "relations" / "paper___cites___paper" /
                     "edge.csv.gz", [[0, 1], [2, 3], [3, 2], [4, 8],
                                     [1, 0], [5, 6]])
        _splits(root / "ogbn_mag" / "split" / "time" / "paper",
                [0, 1, 2, 3, 4], [5, 6], [7, 8])

    t, j = both_roots(tmp_path, write)
    got, ref = tod.load_ogbn_mag_homogeneous(t), \
        jod.load_ogbn_mag_homogeneous(j)
    assert_same(got, ref)
    assert got["num_classes"] == 4 and got["x"].dtype == np.float32
    pairs = set(zip(got["senders"].tolist(), got["receivers"].tolist()))
    assert (8, 4) in pairs and (4, 8) in pairs      # symmetrised


def test_load_ogbg_molhiv_equals_jax(tmp_path):
    sizes = [(3, 2), (2, 1), (4, 5)]
    feats = np.random.default_rng(3).integers(0, 2, size=(9, 9))

    def write(root):
        r = root / "ogbg_molhiv"
        _ogbg_common(r, sizes, feats)
        write_csv_gz(r / "raw" / "graph-label.csv.gz", [[1], [0], [1]])
        _splits(r / "split" / "scaffold", [0, 2], [1], [2])

    t, j = both_roots(tmp_path, write)
    got, ref = tod.load_ogbg_molhiv(t), jod.load_ogbg_molhiv(j)
    assert_same(got, ref)
    assert got["train"][1]["nodes"].shape == (4, 9)


def test_load_ogbg_code2_equals_jax(tmp_path):
    """The augmented AST edges, the depth clamp at 20, the vocabulary of
    the train targets (num_vocab 3: ties by first appearance), the encoded
    targets with UNK and EOS, and the raw words."""
    sizes = [(4, 3), (3, 2), (5, 4)]
    rng = np.random.default_rng(4)
    feats = np.stack([rng.integers(0, 98, 12), rng.integers(0, 50, 12)], 1)
    labels = ["get,name", "set,name,value,of,the,thing", "name"]

    def write(root):
        r = root / "ogbg_code2"
        _ogbg_common(r, sizes, feats)
        write_csv_gz(r / "raw" / "node_is_attributed.csv.gz",
                     (np.arange(12) % 2).reshape(-1, 1))
        write_csv_gz(r / "raw" / "node_depth.csv.gz",
                     np.array([0, 1, 25, 3, 0, 1, 2, 0, 21, 1, 2, 3])
                     .reshape(-1, 1))
        with gzip.open(r / "raw" / "graph-label.csv.gz", "wt") as f:
            f.write("\n".join(labels) + "\n")
        _splits(r / "split" / "project", [0, 1], [2], [1])

    t, j = both_roots(tmp_path, write)
    got = tod.load_ogbg_code2(t, num_vocab=3)
    ref = jod.load_ogbg_code2(j, num_vocab=3)
    assert_same(got, ref)
    g = got["splits"]["train"][0]
    assert g["nodes"][:, 2].max() <= 20 and g["y"].dtype == np.int32
    assert got["idx2vocab"][-2:] == ["__UNK__", "__EOS__"]


def test_code2_helpers_equal_jax():
    seqs = [["get", "name"], ["set", "name"], ["name"], ["a", "b", "get"]]
    for num_vocab in (1, 2, 10):
        got, ref = tod.build_vocab(seqs, num_vocab), \
            jod.build_vocab(seqs, num_vocab)
        assert got == ref
    v2i, i2v = tod.build_vocab(seqs, 2)
    for seq in (["set", "name"], [], ["name"] * 7, ["x", "get", "name"]):
        for seq_len in (3, 5):
            enc = tod.encode_seq(seq, v2i, seq_len)
            np.testing.assert_array_equal(
                enc, jod.encode_seq(seq, v2i, seq_len))
            assert enc.dtype == np.int32
            assert tod.decode_arr(enc, i2v) == jod.decode_arr(enc, i2v)
    rng = np.random.default_rng(5)
    s = rng.integers(0, 7, 6).astype(np.int32)
    r = rng.integers(0, 7, 6).astype(np.int32)
    for att in (np.array([0, 1, 0, 1, 1, 0, 1]), np.zeros(7, int),
                np.ones(7, int)):
        for a, b in zip(tod.augment_ast_edges_np(s, r, att),
                        jod.augment_ast_edges_np(s, r, att)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_load_zinc_equals_jax(tmp_path):
    def mols():
        out = []
        for n in (3, 4, 5):
            adj = np.zeros((n, n), np.int64)
            adj[0, 1] = adj[1, 0] = 1
            adj[n - 1, 0] = adj[0, n - 1] = 2
            out.append({"atom_type": torch.tensor(np.arange(n) % 28),
                        "bond_type": torch.tensor(adj),
                        "logP_SA_cycle_normalized": torch.tensor(0.5 * n)})
        return out

    def write(root):
        raw = root / "ZINC" / "raw"
        raw.mkdir(parents=True)
        for split in ("train", "val", "test"):
            with open(raw / f"{split}.pickle", "wb") as f:
                pickle.dump(mols(), f)
            (raw / f"{split}.index").write_text("2,0")

    t, j = both_roots(tmp_path, write)
    for subset in (True, False):
        got, ref = tod.load_zinc(t, subset=subset), \
            jod.load_zinc(j, subset=subset)
        assert_same(got, ref)
    assert tod.load_zinc(t)["train"][0]["nodes"].shape == (5, 1)


def test_load_cifar10_superpixels_equals_jax(tmp_path):
    rng = np.random.default_rng(6)

    def items(n):
        out = []
        for _ in range(n):
            k = int(rng.integers(3, 6))
            out.append({
                "x": torch.tensor(rng.normal(size=(k, 3)),
                                  dtype=torch.float32),
                "pos": torch.tensor(rng.random(size=(k, 2)),
                                    dtype=torch.float32),
                "edge_index": torch.tensor(rng.integers(0, k,
                                                        size=(2, 2 * k))),
                "y": torch.tensor([int(rng.integers(0, 10))])})
        return out

    data = {split: items(n) for split, n in
            (("train", 4), ("val", 2), ("test", 2))}

    def write(root):
        raw = root / "CIFAR10" / "raw"
        raw.mkdir(parents=True)
        for split, its in data.items():
            torch.save(its, raw / f"CIFAR10_{split}.pt")

    t, j = both_roots(tmp_path, write)
    got, ref = tod.load_cifar10_superpixels(t), \
        jod.load_cifar10_superpixels(j)
    assert_same(got, ref)
    assert got["train"][0]["nodes"].shape[1] == 5


def test_readers_take_dataset_loc(tmp_path, monkeypatch):
    """Without a root every reader looks under ``$DATASET_LOC``, and a
    missing file is named."""
    monkeypatch.setenv("DATASET_LOC", str(tmp_path))
    for reader, missing in ((tod.load_ogbn_mag_homogeneous, "ogbn_mag"),
                            (tod.load_ogbg_molhiv, "ogbg_molhiv"),
                            (tod.load_ogbg_code2, "ogbg_code2"),
                            (tod.load_zinc, "ZINC"),
                            (tod.load_cifar10_superpixels, "CIFAR10")):
        with pytest.raises(FileNotFoundError, match=missing):
            reader()


# ---------------------------------------------------------------------------
# the native CSV parse
# ---------------------------------------------------------------------------

def _csv_text(kind, seed, crlf=False):
    """(text, dtype) of a generated CSV: int64 ids and counts of both
    signs, or float32 features with 9 significant digits, exponents and
    signs (``%.9g`` of values from 1e-12 to 1e12)."""
    rng = np.random.default_rng(seed)
    rows, cols = int(rng.integers(1, 400)), int(rng.integers(1, 9))
    if kind == "int64":
        vals = rng.integers(-2 ** 62, 2 ** 62, size=(rows, cols))
        vals[:, 0] = rng.integers(-5, 5, rows)
        lines = [",".join(str(v) for v in row) for row in vals]
    else:
        vals = rng.normal(size=(rows, cols)) * 10.0 ** rng.integers(
            -12, 12, size=(rows, cols))
        lines = [",".join(f"{v:.9g}" for v in row) for row in vals]
    eol = "\r\n" if crlf else "\n"
    return (eol.join(lines) + eol).encode(), np.dtype(kind)


@pytest.mark.parametrize("crlf", [False, True], ids=["lf", "crlf"])
@pytest.mark.parametrize("kind", ["int64", "float32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_parse_equals_jax_bitwise(kind, seed, crlf):
    """``_parse_csv_bytes`` through the port's parser equals
    ``egc_tpu.native.parse_csv_bytes`` (and the JAX reader's parse) bit
    for bit, with the same row counts."""
    data, dtype = _csv_text(kind, seed, crlf)
    cols = data.split(b"\n", 1)[0].count(b",") + 1
    got = tod._parse_csv_bytes(data, dtype)
    ref = jnative.parse_csv_bytes(data, dtype)
    assert ref is not None, "egc_tpu.native could not build"
    assert got.dtype == ref.dtype == dtype
    assert tnative.csv_rows_consistent(data, cols) == \
        jnative.csv_rows_consistent(data, cols) == got.shape[0]
    np.testing.assert_array_equal(got.view(np.uint8).reshape(-1),
                                  ref.view(np.uint8))
    np.testing.assert_array_equal(got, jod._parse_csv_bytes(data, dtype))


def test_native_float32_rounds_once():
    """A float32 is rounded once from the text: just above the midpoint
    of 1 and its successor rounds up, where a parse through float64 lands
    on the midpoint and rounds to even (1.0)."""
    data = b"1.000000059604644775390626,1\n"
    got = tod._parse_csv_bytes(data, np.float32)
    up = np.nextafter(np.float32(1), np.float32(2))
    assert got[0, 0] == up == jnative.parse_csv_bytes(data, np.float32)[0]
    assert np.float32(float(data.split(b",")[0])) == 1.0


@pytest.mark.parametrize("data", [b"1,2\n3\n", b"1,2\n3,4,5\n",
                                  b"1,2\r\n3,4\r\n5\r\n",
                                  b"1,2\n3 4,5\n"])
def test_native_ragged_rows(data):
    """A row of another field count: both packages' row check returns -1,
    and the port's reader raises."""
    assert tnative.csv_rows_consistent(data, 2) == -1
    assert jnative.csv_rows_consistent(data, 2) == -1
    with pytest.raises(ValueError, match="rows differ"):
        tod._parse_csv_bytes(data, np.int64)


@pytest.mark.parametrize("data,dtype", [
    (b"1,abc\n2,3\n", np.int64), (b"1.5,2\n", np.int64),
    (b"0.5,x1\n", np.float32), (b"1e,2\n", np.float64),
    (b"+1,2\n", np.int64)])
def test_native_rejects_what_is_not_a_number(data, dtype):
    """A field that is not a whole number of the type raises (JAX's parser
    reads it as 0 or a prefix)."""
    with pytest.raises(ValueError, match="not a"):
        tod._parse_csv_bytes(data, dtype)
