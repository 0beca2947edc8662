"""The port's PNG codec and its Image and Write nodes, against the JAX
package (whose decode and encode go through PIL) on the CPU.

PNG files are written here byte by byte (`_png`): every colour type and
bit depth, every row filter, Adam7 interlacing, tRNS chunks. The port's
decode must give the planes of the JAX package's `read_slot_image`, bit
for bit; anything it cannot read becomes the 1×1 magenta placeholder, as
in the JAX package. A Write node's file must decode (through PIL too) to
the u8 export it saved; a Write to another extension than `.png` is an
`IO` error that fails only its graph, a deliberate divergence (the JAX
package lets PIL's `ValueError` escape, which stops its engine). The IHDR
size probe, and that importing the port pulls in no PIL, close the file.
"""

import io
import json
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu.ops import image_io as ref_io
from kanter_core_tpu_torch.ops import image_io as port_io
from test_torch_pernode import _check_reads, sessions  # noqa: F401 — fixture

torch.set_num_threads(1)

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows, bpp, filters):
    """Each row prefixed by its filter type (cycling through `filters`)
    and filtered by it, as the PNG specification defines the filters."""
    out, prior = bytearray(), bytes(len(rows[0]))
    for y, row in enumerate(rows):
        f = filters[y % len(filters)]
        out.append(f)
        for x in range(len(row)):
            a = row[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            out.append((row[x] - (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]) & 255)
        prior = row
    return bytes(out)


def _pack(samples, depth):
    """Rows of `[h, n]` samples as bytes, big-endian, sub-byte samples
    packed from the high bits."""
    rows = []
    for r in samples:
        if depth == 16:
            rows.append(b"".join(struct.pack(">H", int(v)) for v in r))
        elif depth == 8:
            rows.append(bytes(int(v) for v in r))
        else:
            per, acc = 8 // depth, bytearray()
            for i in range(0, len(r), per):
                byte = 0
                for j, v in enumerate(r[i:i + per]):
                    byte |= int(v) << (8 - depth * (j + 1))
                acc.append(byte)
            rows.append(bytes(acc))
    return rows


def _png(samples, ctype, depth, filters=(0,), interlace=False, plte=None, trns=None):
    h, w = samples.shape[:2]
    s = samples.reshape(h, w, -1)
    bpp = max(1, s.shape[2] * depth // 8)
    data = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = s[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, filters)
    out = port_io.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", bytes(plte))
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def _image(ctype, depth, trns, interlace, filters, shape=(13, 11), seed=0):
    rng = np.random.default_rng(seed)
    h, w = shape
    ch = CHANNELS[ctype]
    if ctype == 3:
        samples = rng.integers(0, min(1 << depth, 20), (h, w))  # indices past PLTE too
        plte = rng.integers(0, 256, 3 * min(1 << depth, 16)).tolist()
        alpha = rng.integers(0, 256, min(1 << depth, 16) // 2 + 1).tolist() if trns else None
        return _png(samples, 3, depth, filters, interlace, plte=plte, trns=alpha)
    samples = rng.integers(0, 1 << depth, (h, w, ch))
    trns_bytes = None
    if trns:
        if ctype == 0:
            # a few pixels equal the key; at 16 bits a key of 255 also
            # matches every sample above it (PIL clips before comparing)
            key = 255 if depth == 16 else int(samples[0, 0, 0])
            samples[::3, ::2, 0] = key
            samples[1::4, 1::3, 0] = np.minimum(samples[1::4, 1::3, 0] + 300, (1 << depth) - 1)
            trns_bytes = struct.pack(">H", key)
        else:
            trns_bytes = b"".join(struct.pack(">H", int(v)) for v in samples[0, 0, :3])
    return _png(samples, ctype, depth, filters, interlace, trns=trns_bytes)


FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CASES = [(c, d, False) for c, d in FORMATS] + [
    (c, d, True) for c, d in FORMATS if c in (0, 2, 3)]


def _ids(case):
    c, d, t = case
    return f"type{c}-{d}bit" + ("-trns" if t else "")


def _assert_planes_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape and np.array_equal(g.view(np.int32), w.view(np.int32))


def _ref_planes(path):
    try:
        image = ref_io.read_slot_image(path)
    except ref.TexProError:
        image = ref_io.magenta_placeholder()
    return [p.host_data() for p in image.planes]


@pytest.mark.parametrize("interlace", [False, True], ids=["progressive", "adam7"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_decode_matches_pil(tmp_path, case, interlace):
    ctype, depth, trns = case
    path = tmp_path / "x.png"
    path.write_bytes(_image(ctype, depth, trns, interlace, filters=(0, 1, 2, 3, 4)))
    _assert_planes_equal(port_io.image_planes(str(path)), _ref_planes(str(path)))


def test_palette_without_plte_is_black(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(_png(np.arange(16).reshape(4, 4) % 4, 3, 2, trns=[9, 8]))
    _assert_planes_equal(port_io.image_planes(str(path)), _ref_planes(str(path)))


@pytest.mark.parametrize("f", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_each_filter_alone(tmp_path, f):
    path = tmp_path / "x.png"
    path.write_bytes(_image(6, 8, False, False, filters=(f,), shape=(9, 40), seed=f))
    _assert_planes_equal(port_io.image_planes(str(path)), _ref_planes(str(path)))


def _broken(kind: str) -> bytes:
    good = _image(2, 8, False, False, (1,))
    if kind == "not a png":
        return b"GIF89a" + good[6:]
    if kind == "empty":
        return b""
    if kind == "bad IHDR crc":
        return good[:29] + bytes([good[29] ^ 1]) + good[30:]
    if kind == "truncated":
        return good[:len(good) // 2]
    if kind == "corrupt stream":
        idat = good.index(b"IDAT")
        return good[:idat + 6] + b"\x00" * 12 + good[idat + 18:]
    if kind == "unknown filter":
        rows = b"".join(b"\x05" + bytes(12) for _ in range(4))  # filter type 5
        return (port_io.PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))
    if kind == "RGB at 4 bits":
        return _png(np.zeros((4, 4, 3), int), 2, 4)
    if kind == "decompression bomb":  # 20000² pixels claimed, no data
        return (port_io.PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", 20000, 20000, 8, 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(b"")) + _chunk(b"IEND", b""))
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["missing", "not a png", "empty", "bad IHDR crc", "truncated",
                                  "corrupt stream", "unknown filter", "RGB at 4 bits",
                                  "decompression bomb"])
def test_unreadable_file_is_the_magenta_placeholder(tmp_path, kind):
    path = tmp_path / "x.png"
    if kind != "missing":
        path.write_bytes(_broken(kind))
    got = port_io.image_planes(str(path))
    _assert_planes_equal(got, port_io.magenta_planes())
    _assert_planes_equal(got, _ref_planes(str(path)))
    with pytest.raises(port.TexProError) as err:
        port_io.read_planes(str(path))
    assert err.value.kind == port.ErrorKind.IMAGE


def _image_graph(pkg, path):
    """Image → SeparateRgba → Mix(ADD) of red and green → OutputGray, and
    the Image straight to an OutputRgba."""
    g = pkg.NodeGraph()
    img = g.add_node(pkg.Node(pkg.NodeType.Image(path)))
    sep = g.add_node(pkg.Node(pkg.NodeType.SeparateRgba()))
    g.connect(img, sep, pkg.SlotId(0), pkg.SlotId(0))
    mix = g.add_node(pkg.Node(pkg.NodeType.Mix(pkg.MixType.ADD)))
    g.connect(sep, mix, pkg.SlotId(0), pkg.SlotId(0))
    g.connect(sep, mix, pkg.SlotId(1), pkg.SlotId(1))
    gray = g.add_node(pkg.Node(pkg.NodeType.OutputGray("sum")))
    g.connect(mix, gray, pkg.SlotId(0), pkg.SlotId(0))
    rgba = g.add_node(pkg.Node(pkg.NodeType.OutputRgba("image")))
    g.connect(img, rgba, pkg.SlotId(0), pkg.SlotId(0))
    return g


@pytest.mark.parametrize("route,shards", [("fused", None), ("auto_update", None),
                                          ("no_fuse", None), ("fused", 2), ("no_fuse", 2)],
                         ids=["fused", "auto_update", "no_fuse", "mesh2", "mesh2-no_fuse"])
@pytest.mark.parametrize("file", ["rgb", "missing"])
def test_image_node_matches_reference(sessions, tmp_path, file, route, shards):  # noqa: F811
    path = tmp_path / "x.png"
    if file == "rgb":
        path.write_bytes(_image(2, 8, False, True, (0, 1, 2, 3, 4), shape=(16, 24)))
    graph = _image_graph(ref, str(path))
    outputs = [int(o) for o in graph.output_ids()]
    opened = sessions(graph, {}, [(ref, "fused", None), (port, route, shards)])
    _check_reads(opened, outputs, file)


def _write_session(path, planes, fused=True):
    """A port processor whose graph is InputRgba → Write(path); returns
    (processor, live graph, Write node id)."""
    tp = port.TextureProcessor(100_000_000, device="cpu")
    lg = tp.new_live_graph()
    with lg.write() as g:
        g.fuse_subgraphs = fused
        inp = g.add_node(port.Node(port.NodeType.InputRgba("in")))
        write = g.add_node(port.Node(port.NodeType.Write(str(path))))
        g.connect(inp, write, port.SlotId(0), port.SlotId(0))
        g.add_input_slot_data(port.SlotData(inp, port.SlotId(0), port.SlotImage.Rgba(
            [torch.from_numpy(p) for p in planes])))
        g.request(write)
    return tp, lg, write


def _await(lg, node):
    with port.LiveGraph.await_clean_read(lg, node):
        pass


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "no_fuse"])
def test_write_then_image_round_trip(tmp_path, fused):
    """Write saves the u8 export; an Image node reading the file gives
    `u8 / 255` of it, and PIL reads the same pixels."""
    from PIL import Image

    rng = np.random.default_rng(5)
    planes = [rng.random((21, 34), dtype=np.float32) * np.float32(1.2) - np.float32(0.1)
              for _ in range(4)]
    path = tmp_path / "out.png"
    tp, lg, write = _write_session(path, planes, fused)
    try:
        _await(lg, write)
        export = port.SlotImage.Rgba([torch.from_numpy(p) for p in planes]).to_numpy_rgba()
    finally:
        tp.shutdown_now()
    assert np.array_equal(np.asarray(Image.open(path)), export)
    got = port_io.read_planes(str(path))
    want = [export[:, :, c].astype(np.float32) / np.float32(255) for c in range(4)]
    _assert_planes_equal(got, want)


@pytest.mark.parametrize("name", ["out.jpg", "out.xyz", "missing_dir/out.png"])
def test_write_failure_is_an_io_error_of_its_graph_only(tmp_path, name):
    """A Write the codec cannot save (another extension, an unwritable
    path) fails its graph with an `IO` error and leaves the processor
    running. For `.xyz` the JAX package raises PIL's `ValueError` instead,
    which stops its engine: a deliberate divergence."""
    planes = [np.zeros((4, 4), np.float32)] * 4
    tp, lg, write = _write_session(tmp_path / name, planes)
    try:
        with pytest.raises(port.TexProError) as err:
            _await(lg, write)
        assert err.value.kind == port.ErrorKind.IO
        assert not tp.shutdown.load()
        assert not (tmp_path / name).exists()
    finally:
        tp.shutdown_now()
    if name.endswith(".xyz"):
        with pytest.raises(ValueError):
            ref_io.save_rgba_png(str(tmp_path / name), np.zeros(64, np.uint8), ref.Size(4, 4))


def test_ihdr_size_probe(tmp_path):
    from PIL import Image

    path = tmp_path / "x.png"
    path.write_bytes(_image(6, 8, False, True, (4,), shape=(7, 19)))
    assert port_io.image_size(str(path)) == Image.open(path).size == (19, 7)
    path.write_bytes(_image(0, 1, False, False, (0,), shape=(30, 3)))
    assert port_io.image_size(str(path)) == (3, 30)
    assert port_io.image_size(str(tmp_path / "missing.png")) == (1, 1)
    (tmp_path / "junk.png").write_bytes(b"junk" * 20)
    assert port_io.image_size(str(tmp_path / "junk.png")) == (1, 1)


def test_encode_is_valid_png_read_by_pil():
    from PIL import Image

    pixels = np.random.default_rng(9).integers(0, 256, (17, 23, 4), dtype=np.uint8)
    data = port_io.encode_png(pixels)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), pixels)
    assert np.array_equal(port_io.decode_png(data), pixels)


def test_import_pulls_in_no_pil():
    code = (
        "import sys, numpy as np, kanter_core_tpu_torch, kanter_core_tpu_torch.parallel; "
        "from kanter_core_tpu_torch.ops import image_io; "
        "data = image_io.encode_png(np.zeros((3, 5, 4), np.uint8)); "
        "assert image_io.decode_png(data).shape == (3, 5, 4); "
        "bad = [m for m in sys.modules if m == 'PIL' or m.startswith('PIL.') "
        "or m == 'jax' or m.startswith('jax.') or m.startswith('kanter_core_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_image_node_serde_keeps_the_path(tmp_path):
    g = port.NodeGraph()
    g.add_node(port.Node(port.NodeType.Image(str(tmp_path / "a.png"))))
    g.add_node(port.Node(port.NodeType.Write(str(tmp_path / "b.png"))))
    text = json.dumps(g.to_json())
    assert json.dumps(port.NodeGraph.from_json(json.loads(text)).to_json()) == text
