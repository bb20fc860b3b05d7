"""CSS checkpoints -> the port's ConformerCSS state dict.

Port of notsofar_tpu/models/convert.py plus the weight bridge from the JAX
package's formats:

* ``convert_css_state_dict``: a reference ConformerCssWrapper torch state
  dict ('module.' prefix stripped; ``load_torch_checkpoint``) -> state
  dict. The reference keys map onto the flax tree the JAX converter
  builds, which ``variables_from_jax`` then maps by name.
* ``variables_from_jax``: flax variables {'params', 'batch_stats',
  'constants'} with numpy (or array-like) leaves -> state dict.
* ``read_flax_msgpack``: the native ``params.msgpack`` that the JAX
  package's ``save_css_model`` writes (flax's msgpack layout: nested maps,
  each ndarray an ext record 1 holding msgpack (shape, dtype name,
  bytes)), decoded here without msgpack or flax.

The STFT kernels in the reference checkpoint (executor.extractor.*.K) are
ignored: they are deterministic and recomputed.
"""
import struct
from typing import Dict

import numpy as np
import torch


def _t(x):  # torch Linear stores [out, in]; flax Dense wants [in, out]
    return np.ascontiguousarray(np.asarray(x).T)


def _a(x):
    return np.ascontiguousarray(np.asarray(x))


def reference_to_flax_tree(sd: Dict[str, np.ndarray], num_blocks: int
                           ) -> Dict:
    """Reference state dict (numpy values) -> the JAX package's flax
    variables layout (the JAX convert_css_state_dict)."""
    P = "executor.nnet."

    def g(key):
        return sd[P + key]

    enc: Dict = {
        "embed": {"kernel": _t(g("conformer.embed.0.weight")),
                  "bias": _a(g("conformer.embed.0.bias"))},
        "embed_ln": {"scale": _a(g("conformer.embed.1.weight")),
                     "bias": _a(g("conformer.embed.1.bias"))},
        "pos_emb": _a(g("conformer.pos_emb.pe_k.weight")),
    }
    enc_bs: Dict = {}
    for i in range(num_blocks):
        L = f"conformer.encoders.{i}."

        def gl(key):
            return sd[P + L + key]

        def ln(name):
            return {"scale": _a(gl(f"{name}.weight")),
                    "bias": _a(gl(f"{name}.bias"))}

        def dense(name):
            return {"kernel": _t(gl(f"{name}.weight")),
                    "bias": _a(gl(f"{name}.bias"))}

        def ffn(name):
            return {"ln": ln(f"{name}.layer_norm"),
                    "w1": dense(f"{name}.net.0"),
                    "w2": dense(f"{name}.net.3")}

        enc[f"layer_{i}"] = {
            "ffn_in": ffn("feed_forward_in"),
            "ffn_out": ffn("feed_forward_out"),
            "attn": {"ln": ln("self_attn.layer_norm"),
                     "q": dense("self_attn.linear_q"),
                     "k": dense("self_attn.linear_k"),
                     "v": dense("self_attn.linear_v"),
                     "out": dense("self_attn.linear_out")},
            "conv": {
                "ln": ln("conv.layer_norm"),
                # Conv2d(1,2,1): weight [2,1,1,1] -> two scalars
                "pw1_w": _a(gl("conv.pw_conv_1.weight")).reshape(2),
                "pw1_b": _a(gl("conv.pw_conv_1.bias")).reshape(2),
                # depthwise Conv1d: torch [D, 1, K] -> flax (K, 1, D)
                "dw": {"kernel": _a(gl("conv.dw_conv_1d.weight"))
                       .transpose(2, 1, 0),
                       "bias": _a(gl("conv.dw_conv_1d.bias"))},
                "bn": {"scale": _a(gl("conv.BN.weight")),
                       "bias": _a(gl("conv.BN.bias"))},
                "pw2_w": _a(gl("conv.pw_conv_2.weight")).reshape(1),
                "pw2_b": _a(gl("conv.pw_conv_2.bias")).reshape(1),
            },
            "ln_out": ln("layer_norm"),
        }
        enc_bs[f"layer_{i}"] = {"conv": {"bn": {
            "mean": _a(gl("conv.BN.running_mean")),
            "var": _a(gl("conv.BN.running_var"))}}}
    params = {"encoder": enc,
              "mask_head": {"kernel": _t(g("linear.weight")),
                            "bias": _a(g("linear.bias"))}}
    constants = {"input_bias": _a(g("input_bias")).reshape(-1),
                 "input_scale": _a(g("input_scale")).reshape(-1)}
    return {"params": params, "batch_stats": {"encoder": enc_bs},
            "constants": constants}


def variables_from_jax(variables) -> Dict[str, torch.Tensor]:
    """Flax ConformerCSS variables -> ConformerCSS state dict (f32).

    Dense kernels (in, out) -> weight [out, in]; the depthwise conv kernel
    (k, 1, D) -> Conv1d weight [D, 1, k]; LayerNorm/BatchNorm scale ->
    weight; batch_stats mean/var -> running_mean/running_var; constants
    and bare parameters (pos_emb, pw*_w, pw*_b) keep their names."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))

    def walk(tree, path, stats):
        for name, v in tree.items():
            p = path + [name]
            if isinstance(v, dict):
                walk(v, p, stats)
                continue
            a = np.asarray(v, dtype=np.float32)
            prefix = ".".join(path)
            if stats:
                key = {"mean": "running_mean", "var": "running_var"}[name]
                sd[f"{prefix}.{key}"] = t(a)
            elif name == "kernel" and path[-1] == "dw":
                sd[f"{prefix}.weight"] = t(a.transpose(2, 1, 0))
            elif name == "kernel":
                sd[f"{prefix}.weight"] = t(a.T)
            elif name == "scale":
                sd[f"{prefix}.weight"] = t(a)
            else:
                sd[".".join(p)] = t(a)

    walk(dict(variables["params"]), [], stats=False)
    walk(dict(variables.get("batch_stats", {})), [], stats=True)
    walk(dict(variables.get("constants", {})), [], stats=False)
    return sd


def convert_css_state_dict(sd: Dict[str, np.ndarray], num_blocks: int
                           ) -> Dict[str, torch.Tensor]:
    """Reference ConformerCssWrapper state dict (numpy-valued, 'module.'
    prefix stripped) -> ConformerCSS state dict."""
    return variables_from_jax(reference_to_flax_tree(sd, num_blocks))


def load_torch_checkpoint(path) -> Dict[str, np.ndarray]:
    """A reference .pt checkpoint as a numpy state dict, with the DDP
    'module.' prefix stripped."""
    cpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = cpt["model"] if "model" in cpt else cpt
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# flax msgpack reader
# ---------------------------------------------------------------------------

class _Reader:
    """A msgpack decoder for what flax.serialization.to_bytes writes:
    maps, arrays, strings, binaries, numbers, nil, booleans and ext
    records (1: ndarray, 2: python complex, 3: numpy scalar)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode()
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
                 0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
                 0xdc: ">H", 0xdd: ">I",                   # array
                 0xde: ">H", 0xdf: ">I",                   # map
                 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}       # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b in (0xc4, 0xc5, 0xc6):
                return bytes(self.take(n))
            if b in (0xc7, 0xc8, 0xc9):
                return self.ext(n)
            if b in (0xd9, 0xda, 0xdb):
                return bytes(self.take(n)).decode()
            if b in (0xdc, 0xdd):
                return self.array(n)
            return self.map(n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code in (1, 3):
            shape, dtype, raw = _Reader(data).value()
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
            return arr if code == 1 else arr[()]
        if code == 2:
            re, im = _Reader(data).value()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    """flax splits arrays over 1 GiB into {'__msgpack_chunked_array__',
    'shape', 'chunks'} maps; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(data: bytes) -> Dict:
    """Decode flax.serialization.to_bytes output into nested dicts of
    numpy arrays."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)
