# Frozen copy of lyra_tpu_torch/tflite/model.py at commit d33c86f8529266b8cfd7b29e220ae5f0401d98aa, for the benchmark's plain
# reference: the import of flatbuffer is the local copy.
"""TFLite model file → neutral graph description — the port's copy of
lyra_tpu/tflite/model.py.

Parses .tflite flatbuffers (schema v3) into plain dataclasses: tensors with
shape/dtype/quantization/constant-data, operators with decoded options, and
signature defs.  The options decoder covers the ops of the Lyra graphs
(SoundStream, LyraGAN, quantizer); any other op parses with empty options.
tests/test_torch_executor.py holds the result equal to the JAX package's
parser on every graph of both fixtures.

No TensorFlow dependency — the flatbuffer is read directly (flatbuffer.py).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from portbench.reference import flatbuffer as fb

# --- TensorType enum -> numpy dtype ---------------------------------------
TENSOR_DTYPES = {
    0: np.float32,
    1: np.float16,
    2: np.int32,
    3: np.uint8,
    4: np.int64,
    5: object,  # STRING
    6: np.bool_,
    7: np.int16,
    9: np.int8,
    10: np.float64,
    12: np.uint64,
    13: object,  # RESOURCE
    14: object,  # VARIANT
    15: np.uint32,
    16: np.uint16,
}

# --- BuiltinOperator enum (schema.fbs) ------------------------------------
BUILTIN_OP_NAMES = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 5: "DEPTH_TO_SPACE", 6: "DEQUANTIZE",
    7: "EMBEDDING_LOOKUP", 8: "FLOOR", 9: "FULLY_CONNECTED",
    10: "HASHTABLE_LOOKUP", 11: "L2_NORMALIZATION", 12: "L2_POOL_2D",
    13: "LOCAL_RESPONSE_NORMALIZATION", 14: "LOGISTIC", 15: "LSH_PROJECTION",
    16: "LSTM", 17: "MAX_POOL_2D", 18: "MUL", 19: "RELU", 20: "RELU_N1_TO_1",
    21: "RELU6", 22: "RESHAPE", 23: "RESIZE_BILINEAR", 24: "RNN",
    25: "SOFTMAX", 26: "SPACE_TO_DEPTH", 27: "SVDF", 28: "TANH",
    29: "CONCAT_EMBEDDINGS", 30: "SKIP_GRAM", 31: "CALL", 32: "CUSTOM",
    33: "EMBEDDING_LOOKUP_SPARSE", 34: "PAD", 35: "UNIDIRECTIONAL_SEQUENCE_RNN",
    36: "GATHER", 37: "BATCH_TO_SPACE_ND", 38: "SPACE_TO_BATCH_ND",
    39: "TRANSPOSE", 40: "MEAN", 41: "SUB", 42: "DIV", 43: "SQUEEZE",
    44: "UNIDIRECTIONAL_SEQUENCE_LSTM", 45: "STRIDED_SLICE",
    46: "BIDIRECTIONAL_SEQUENCE_RNN", 47: "EXP", 48: "TOPK_V2", 49: "SPLIT",
    50: "LOG_SOFTMAX", 51: "DELEGATE", 52: "BIDIRECTIONAL_SEQUENCE_LSTM",
    53: "CAST", 54: "PRELU", 55: "MAXIMUM", 56: "ARG_MAX", 57: "MINIMUM",
    58: "LESS", 59: "NEG", 60: "PADV2", 61: "GREATER", 62: "GREATER_EQUAL",
    63: "LESS_EQUAL", 64: "SELECT", 65: "SLICE", 66: "SIN",
    67: "TRANSPOSE_CONV", 68: "SPARSE_TO_DENSE", 69: "TILE",
    70: "EXPAND_DIMS", 71: "EQUAL", 72: "NOT_EQUAL", 73: "LOG", 74: "SUM",
    75: "SQRT", 76: "RSQRT", 77: "SHAPE", 78: "POW", 79: "ARG_MIN",
    80: "FAKE_QUANT", 81: "REDUCE_PROD", 82: "REDUCE_MAX", 83: "PACK",
    84: "LOGICAL_OR", 85: "ONE_HOT", 86: "LOGICAL_AND", 87: "LOGICAL_NOT",
    88: "UNPACK", 89: "REDUCE_MIN", 90: "FLOOR_DIV", 91: "REDUCE_ANY",
    92: "SQUARE", 93: "ZEROS_LIKE", 94: "FILL", 95: "FLOOR_MOD", 96: "RANGE",
    97: "RESIZE_NEAREST_NEIGHBOR", 98: "LEAKY_RELU", 99: "SQUARED_DIFFERENCE",
    100: "MIRROR_PAD", 101: "ABS", 102: "SPLIT_V", 103: "UNIQUE", 104: "CEIL",
    105: "REVERSE_V2", 106: "ADD_N", 107: "GATHER_ND", 108: "COS",
    109: "WHERE", 110: "RANK", 111: "ELU", 112: "REVERSE_SEQUENCE",
    113: "MATRIX_DIAG", 114: "QUANTIZE", 115: "MATRIX_SET_DIAG", 116: "ROUND",
    117: "HARD_SWISH", 118: "IF", 119: "WHILE", 120: "NON_MAX_SUPPRESSION_V4",
    121: "NON_MAX_SUPPRESSION_V5", 122: "SCATTER_ND", 123: "SELECT_V2",
    124: "DENSIFY", 125: "SEGMENT_SUM", 126: "BATCH_MATMUL",
    127: "PLACEHOLDER", 128: "CUMSUM", 129: "CALL_ONCE", 130: "BROADCAST_TO",
    131: "RFFT2D", 132: "CONV_3D", 133: "IMAG", 134: "REAL",
    135: "COMPLEX_ABS", 136: "HASHTABLE", 137: "HASHTABLE_FIND",
    138: "HASHTABLE_IMPORT", 139: "HASHTABLE_SIZE", 140: "REDUCE_ALL",
    141: "CONV_3D_TRANSPOSE", 142: "VAR_HANDLE", 143: "READ_VARIABLE",
    144: "ASSIGN_VARIABLE", 145: "BROADCAST_ARGS", 146: "RANDOM_STANDARD_NORMAL",
    147: "BUCKETIZE", 148: "RANDOM_UNIFORM", 149: "MULTINOMIAL",
    150: "GELU", 151: "DYNAMIC_UPDATE_SLICE", 152: "RELU_0_TO_1",
    153: "UNSORTED_SEGMENT_PROD", 154: "UNSORTED_SEGMENT_MAX",
    155: "UNSORTED_SEGMENT_SUM", 156: "ATAN2", 157: "UNSORTED_SEGMENT_MIN",
    158: "SIGN", 159: "BITCAST", 160: "BITWISE_XOR", 161: "RIGHT_SHIFT",
}

_ACTIVATIONS = {0: None, 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6", 4: "TANH", 5: "SIGN_BIT"}
_PADDINGS = {0: "SAME", 1: "VALID"}


@dataclasses.dataclass
class QuantParams:
    scale: np.ndarray  # [1] or per-channel
    zero_point: np.ndarray  # int64
    quantized_dimension: int = 0

    @property
    def per_channel(self) -> bool:
        return self.scale.size > 1


@dataclasses.dataclass
class TensorDef:
    index: int
    name: str
    shape: Tuple[int, ...]
    dtype: Any
    quant: Optional[QuantParams]
    is_variable: bool
    data: Optional[np.ndarray]  # constant data or None


@dataclasses.dataclass
class OpDef:
    index: int
    name: str  # builtin op name
    inputs: List[int]  # tensor indices; -1 for optional-absent
    outputs: List[int]
    options: Dict[str, Any]


@dataclasses.dataclass
class SubGraphDef:
    index: int
    name: str
    tensors: List[TensorDef]
    inputs: List[int]
    outputs: List[int]
    ops: List[OpDef]


@dataclasses.dataclass
class ModelDef:
    subgraphs: List[SubGraphDef]
    signatures: Dict[str, Dict[str, Any]]  # key -> {inputs, outputs, subgraph}
    description: str = ""


def _decode_options(op_name: str, t: Optional[fb.Table]) -> Dict[str, Any]:
    """Decode the BuiltinOptions union for the ops of the Lyra graphs."""
    if t is None:
        return {}
    if op_name == "CONV_2D":
        return dict(
            padding=_PADDINGS[t.i8(0)], stride_w=t.i32(1), stride_h=t.i32(2),
            activation=_ACTIVATIONS[t.i8(3)], dilation_w=t.i32(4, 1), dilation_h=t.i32(5, 1),
        )
    if op_name == "DEPTHWISE_CONV_2D":
        return dict(
            padding=_PADDINGS[t.i8(0)], stride_w=t.i32(1), stride_h=t.i32(2),
            depth_multiplier=t.i32(3), activation=_ACTIVATIONS[t.i8(4)],
            dilation_w=t.i32(5, 1), dilation_h=t.i32(6, 1),
        )
    if op_name == "TRANSPOSE_CONV":
        return dict(
            padding=_PADDINGS[t.i8(0)], stride_w=t.i32(1), stride_h=t.i32(2),
            activation=_ACTIVATIONS[t.i8(3)],
        )
    if op_name == "CONCATENATION":
        return dict(axis=t.i32(0), activation=_ACTIVATIONS[t.i8(1)])
    if op_name in ("ADD", "SUB", "MUL", "DIV"):
        return dict(activation=_ACTIVATIONS[t.i8(0)])
    if op_name == "LEAKY_RELU":
        return dict(alpha=t.f32(0))
    if op_name == "STRIDED_SLICE":
        return dict(
            begin_mask=t.i32(0), end_mask=t.i32(1), ellipsis_mask=t.i32(2),
            new_axis_mask=t.i32(3), shrink_axis_mask=t.i32(4),
        )
    if op_name == "SPLIT":
        return dict(num_splits=t.i32(0))
    if op_name == "GATHER":
        return dict(axis=t.i32(0), batch_dims=t.i32(1))
    if op_name == "CAST":
        return dict(in_dtype=t.i8(0), out_dtype=t.i8(1))
    if op_name == "VAR_HANDLE":
        return dict(container=t.string(0), shared_name=t.string(1))
    if op_name == "RESHAPE":
        return dict(new_shape=t.scalar_vector(0, np.int32).tolist())
    if op_name == "CALL_ONCE":
        return dict(init_subgraph_index=t.i32(0))
    if op_name == "PACK":
        return dict(values_count=t.i32(0), axis=t.i32(1))
    if op_name in ("ARG_MIN", "ARG_MAX"):
        return dict(output_type=t.i8(0))
    if op_name == "SUM":
        return dict(keep_dims=t.bool_(0))
    return {}


def load(path: str) -> ModelDef:
    with open(path, "rb") as f:
        data = f.read()
    if fb.file_identifier(data) != "TFL3":
        raise ValueError(f"{path}: not a TFLite v3 flatbuffer")
    try:
        return _parse(path, data)
    except (struct.error, IndexError, OverflowError, MemoryError) as e:
        # A truncated or bit-flipped flatbuffer fails deep inside offset
        # arithmetic; surface it as a clean invalid-model error instead of
        # leaking parser internals (the reference's analog is TFLite's
        # flatbuffer verifier rejecting the model at load,
        # lyra/tflite_model_wrapper.cc:41-49).
        raise ValueError(f"{path}: corrupt or truncated TFLite model "
                         f"({type(e).__name__}: {e})") from e


def _parse(path: str, data: bytes) -> ModelDef:
    model = fb.root(data)

    # operator codes
    op_names = []
    for oc in model.table_vector(1):
        code = max(oc.i8(0), oc.i32(3))
        name = BUILTIN_OP_NAMES.get(code, f"OP_{code}")
        if name == "CUSTOM":
            name = f"CUSTOM:{oc.string(1)}"
        op_names.append(name)

    buffers = model.table_vector(4)

    subgraphs = []
    for sg_idx, sg in enumerate(model.table_vector(2)):
        tensors = []
        for t_idx, t in enumerate(sg.table_vector(0)):
            shape = tuple(int(x) for x in t.scalar_vector(0, np.int32))
            ttype = t.i8(1)
            dtype = TENSOR_DTYPES.get(ttype, object)
            buf_idx = t.u32(2)
            raw = buffers[buf_idx].bytes_vector(0) if buf_idx < len(buffers) else b""
            const = None
            if raw and dtype is not object:
                const = np.frombuffer(raw, dtype=dtype).reshape(shape)
            quant = None
            qt = t.table(4)
            if qt is not None:
                scale = np.array(qt.scalar_vector(2, np.float32))
                zp = np.array(qt.scalar_vector(3, np.int64))
                if scale.size:
                    quant = QuantParams(scale=scale, zero_point=zp, quantized_dimension=qt.i32(6))
            tensors.append(
                TensorDef(
                    index=t_idx, name=t.string(3, f"t{t_idx}"), shape=shape,
                    dtype=dtype, quant=quant, is_variable=t.bool_(5), data=const,
                )
            )

        ops = []
        for o_idx, op in enumerate(sg.table_vector(3)):
            name = op_names[op.u32(0)]
            opts = _decode_options(name, op.table(4))
            ops.append(
                OpDef(
                    index=o_idx, name=name,
                    inputs=[int(x) for x in op.scalar_vector(1, np.int32)],
                    outputs=[int(x) for x in op.scalar_vector(2, np.int32)],
                    options=opts,
                )
            )

        subgraphs.append(
            SubGraphDef(
                index=sg_idx, name=sg.string(4, f"subgraph{sg_idx}"),
                tensors=tensors,
                inputs=[int(x) for x in sg.scalar_vector(1, np.int32)],
                outputs=[int(x) for x in sg.scalar_vector(2, np.int32)],
                ops=ops,
            )
        )

    signatures = {}
    for sd in model.table_vector(7):
        key = sd.string(2)
        sig_inputs = {tm.string(0): tm.u32(1) for tm in sd.table_vector(0)}
        sig_outputs = {tm.string(0): tm.u32(1) for tm in sd.table_vector(1)}
        signatures[key] = dict(
            inputs=sig_inputs, outputs=sig_outputs, subgraph=sd.u32(4)
        )

    return ModelDef(
        subgraphs=subgraphs, signatures=signatures, description=model.string(3, "")
    )
