"""In-file TFLite metadata WITHOUT ``tflite_support``.

The port's own copy of ``unet_image_segmentation_tpu/export/tflite_metadata.py``
(same strings and slots, so the same dict gives the same flatbuffer bytes).
``flatbuffers`` and TensorFlow's generated schema are imported inside the
functions that need them, so the module imports where neither is installed.

The reference embeds a flatbuffer ``ModelMetadata`` into the ``.tflite``
file and appends the label file as a zip member (reference
``scripts/tensorflow_lite/add_tflite_metadata.py:203-317``, which drives
``tflite_support.metadata.MetadataPopulator``).  ``tflite_support`` is not
in this environment, so this module builds the same artifacts from
first principles:

* the metadata flatbuffer is hand-assembled with the ``flatbuffers``
  runtime (a TF dependency, always present) against the public
  ``metadata_schema.fbs`` layout — the same approach as the hand-rolled
  TensorBoard protobuf writer (:mod:`..utils.tb_writer`);
* the model file is re-serialized through TensorFlow's own generated
  TFLite schema (``tensorflow.lite.python.schema_py_generated``) with the
  metadata attached as a named buffer (``TFLITE_METADATA``);
* associated files ride as a zip appended to the flatbuffer — the format
  ``tflite_support`` readers and the TFLite Task library expect (a
  flatbuffer parser ignores trailing bytes; a zip reader locates the
  central directory from the end).

Schema field slots below follow metadata_schema.fbs (schema_version
"1.0.0"); each ``StartObject``/slot pair is annotated with the field it
encodes so the layout is auditable against the public schema.
"""

from __future__ import annotations

import os
import zipfile
from typing import TYPE_CHECKING, Dict, Optional, Sequence

if TYPE_CHECKING:
    import flatbuffers

METADATA_BUFFER_NAME = "TFLITE_METADATA"
METADATA_FILE_IDENTIFIER = b"M001"
TFLITE_FILE_IDENTIFIER = b"TFL3"

# metadata_schema.fbs enums
COLOR_SPACE_RGB = 1
CONTENT_PROPERTIES_IMAGE = 2        # union ContentProperties.ImageProperties
PROCESS_UNIT_NORMALIZATION = 1      # union ProcessUnitOptions.NormalizationOptions
FILE_TYPE_TENSOR_AXIS_LABELS = 2    # AssociatedFileType.TENSOR_AXIS_LABELS


def _string(b: flatbuffers.Builder, s: Optional[str]):
    return b.CreateString(s) if s else None


def _float_vector(b: flatbuffers.Builder, values: Sequence[float]) -> int:
    b.StartVector(4, len(values), 4)
    for v in reversed(list(values)):
        b.PrependFloat32(float(v))
    return b.EndVector()


def _offset_vector(b: flatbuffers.Builder, offsets: Sequence[int]) -> int:
    b.StartVector(4, len(offsets), 4)
    for off in reversed(list(offsets)):
        b.PrependUOffsetTRelative(off)
    return b.EndVector()


def _table(b: flatbuffers.Builder, n_slots: int, slots: Dict[int, tuple]) -> int:
    """Assemble one table: ``slots`` maps field id -> (kind, value)."""
    b.StartObject(n_slots)
    for slot, (kind, value) in slots.items():
        if value is None:
            continue
        if kind == "offset":
            b.PrependUOffsetTRelativeSlot(slot, value, 0)
        elif kind == "byte":
            b.PrependInt8Slot(slot, value, 0)
        else:
            raise ValueError(kind)
    return b.EndObject()


def _associated_file(
    b: flatbuffers.Builder, name: str, description: str, ftype: int
) -> int:
    name_off = _string(b, name)
    desc_off = _string(b, description)
    # AssociatedFile: name(0) description(1) type(2) locale(3) version(4)
    return _table(b, 5, {
        0: ("offset", name_off),
        1: ("offset", desc_off),
        2: ("byte", ftype),
    })


def _input_tensor_metadata(b: flatbuffers.Builder, meta: dict) -> int:
    norm = meta["input"]["normalization"]
    mean_off = _float_vector(b, norm["mean"])
    std_off = _float_vector(b, norm["std"])
    # NormalizationOptions: mean(0) std(1)
    norm_off = _table(b, 2, {
        0: ("offset", mean_off),
        1: ("offset", std_off),
    })
    # ProcessUnit: options_type(0) options(1)
    pu_off = _table(b, 2, {
        0: ("byte", PROCESS_UNIT_NORMALIZATION),
        1: ("offset", norm_off),
    })
    pus_off = _offset_vector(b, [pu_off])

    # ImageProperties: color_space(0) default_size(1)
    img_off = _table(b, 2, {0: ("byte", COLOR_SPACE_RGB)})
    # Content: content_properties_type(0) content_properties(1) range(2)
    content_off = _table(b, 3, {
        0: ("byte", CONTENT_PROPERTIES_IMAGE),
        1: ("offset", img_off),
    })

    # Stats: max(0) min(1) — float input in [0, 1]
    stats_off = _table(b, 2, {
        0: ("offset", _float_vector(b, [1.0])),
        1: ("offset", _float_vector(b, [0.0])),
    })

    name_off = _string(b, "input_image")
    desc_off = _string(
        b,
        "Input frame, RGB, float32, normalized to [0, 1] "
        f"({meta['input']['shape'][1]}x{meta['input']['shape'][2]}).",
    )
    # TensorMetadata: name(0) description(1) dimension_names(2) content(3)
    #                 process_units(4) stats(5) associated_files(6)
    return _table(b, 7, {
        0: ("offset", name_off),
        1: ("offset", desc_off),
        3: ("offset", content_off),
        4: ("offset", pus_off),
        5: ("offset", stats_off),
    })


def _output_tensor_metadata(
    b: flatbuffers.Builder, meta: dict, label_filename: Optional[str]
) -> int:
    files_off = None
    if label_filename:
        f_off = _associated_file(
            b, label_filename, "Class labels (one per line).",
            FILE_TYPE_TENSOR_AXIS_LABELS,
        )
        files_off = _offset_vector(b, [f_off])
    stats_off = _table(b, 2, {
        0: ("offset", _float_vector(b, [1.0])),
        1: ("offset", _float_vector(b, [0.0])),
    })
    num_classes = meta["output"]["shape"][-1]
    if num_classes == 1:
        desc = (
            "Per-pixel foreground probability mask; binarize at "
            f"{meta['output'].get('binarization_threshold', 0.5)}."
        )
    else:
        desc = f"Per-pixel {num_classes}-class softmax probability map."
    name_off = _string(b, "segmentation_mask")
    desc_off = _string(b, desc)
    return _table(b, 7, {
        0: ("offset", name_off),
        1: ("offset", desc_off),
        5: ("offset", stats_off),
        6: ("offset", files_off),
    })


def build_metadata_flatbuffer(
    meta: dict, label_filename: Optional[str] = None
) -> bytes:
    """Serialize ``meta`` (the JSON-sidecar dict) as a metadata flatbuffer."""
    import flatbuffers

    b = flatbuffers.Builder(1024)
    in_off = _input_tensor_metadata(b, meta)
    out_off = _output_tensor_metadata(b, meta, label_filename)
    ins_off = _offset_vector(b, [in_off])
    outs_off = _offset_vector(b, [out_off])
    sg_name = _string(b, "unet_segmentation")
    sg_desc = _string(
        b, "U-Net document segmentation (reference model/u_net.py parity)."
    )
    # SubGraphMetadata: name(0) description(1) input_tensor_metadata(2)
    #   output_tensor_metadata(3) associated_files(4) input_process_units(5)
    #   output_process_units(6) input_tensor_groups(7) output_tensor_groups(8)
    sg_off = _table(b, 9, {
        0: ("offset", sg_name),
        1: ("offset", sg_desc),
        2: ("offset", ins_off),
        3: ("offset", outs_off),
    })
    sgs_off = _offset_vector(b, [sg_off])
    name_off = _string(b, meta.get("name"))
    desc_off = _string(
        b, "Binary/multi-class document segmentation (TPU-native U-Net)."
    )
    version_off = _string(b, meta.get("version"))
    author_off = _string(b, meta.get("author", "unet-image-segmentation-tpu"))
    license_off = _string(b, meta.get("license", "MIT"))
    minver_off = _string(b, "1.0.0")
    # ModelMetadata: name(0) description(1) version(2) subgraph_metadata(3)
    #   author(4) license(5) associated_files(6) min_parser_version(7)
    mm_off = _table(b, 8, {
        0: ("offset", name_off),
        1: ("offset", desc_off),
        2: ("offset", version_off),
        3: ("offset", sgs_off),
        4: ("offset", author_off),
        5: ("offset", license_off),
        7: ("offset", minver_off),
    })
    b.Finish(mm_off, METADATA_FILE_IDENTIFIER)
    return bytes(b.Output())


def embed_metadata(
    tflite_path: str,
    metadata_blob: bytes,
    associated_files: Sequence[str] = (),
) -> None:
    """Attach ``metadata_blob`` to the model and append associated files.

    Re-serializes the model through TF's generated TFLite schema: the blob
    becomes a new entry in ``Model.buffers`` referenced by a
    ``Model.metadata`` row named ``TFLITE_METADATA`` (replacing any prior
    one), exactly what ``MetadataPopulator`` produces.
    """
    import flatbuffers
    import numpy as np
    from tensorflow.lite.python import schema_py_generated as tflite_schema

    with open(tflite_path, "rb") as f:
        model_buf = bytearray(f.read())
    model = tflite_schema.ModelT.InitFromPackedBuf(bytes(model_buf), 0)

    buffer_t = tflite_schema.BufferT()
    buffer_t.data = np.frombuffer(metadata_blob, dtype=np.uint8)
    existing = None
    for m in model.metadata or []:
        name = m.name.decode() if isinstance(m.name, bytes) else m.name
        if name == METADATA_BUFFER_NAME:
            existing = m
            break
    if existing is not None:
        model.buffers[existing.buffer] = buffer_t
    else:
        model.buffers = list(model.buffers or [])
        model.buffers.append(buffer_t)
        meta_t = tflite_schema.MetadataT()
        meta_t.name = METADATA_BUFFER_NAME
        meta_t.buffer = len(model.buffers) - 1
        model.metadata = list(model.metadata or []) + [meta_t]

    builder = flatbuffers.Builder(len(model_buf))
    builder.Finish(model.Pack(builder), TFLITE_FILE_IDENTIFIER)
    with open(tflite_path, "wb") as f:
        f.write(bytes(builder.Output()))

    if associated_files:
        # zip appended after the flatbuffer (the populator's packing format)
        with zipfile.ZipFile(tflite_path, "a", zipfile.ZIP_STORED) as z:
            for path in associated_files:
                z.write(path, arcname=os.path.basename(path))


# ---------------------------------------------------------------------------
# Minimal reader (verification / tooling; no tflite_support)
# ---------------------------------------------------------------------------


def _tbl(buf: bytes, pos: int):
    from flatbuffers import encode, number_types as N
    from flatbuffers.table import Table

    return Table(buf, pos + encode.Get(N.UOffsetTFlags.packer_type, buf, pos))


def _field_str(tab, field_id: int) -> Optional[str]:
    o = tab.Offset(4 + 2 * field_id)
    if not o:
        return None
    s = tab.String(o + tab.Pos)
    return s.decode() if isinstance(s, bytes) else s


def read_metadata(tflite_path: str) -> dict:
    """Extract {name, version, min_parser_version, associated_files} from an
    embedded metadata buffer (raises if none present)."""
    from tensorflow.lite.python import schema_py_generated as tflite_schema

    with open(tflite_path, "rb") as f:
        buf = f.read()
    model = tflite_schema.ModelT.InitFromPackedBuf(buf, 0)
    blob = None
    for m in model.metadata or []:
        name = m.name.decode() if isinstance(m.name, bytes) else m.name
        if name == METADATA_BUFFER_NAME:
            blob = bytes(bytearray(model.buffers[m.buffer].data))
            break
    if blob is None:
        raise ValueError(f"no {METADATA_BUFFER_NAME} buffer in {tflite_path}")
    if blob[4:8] != METADATA_FILE_IDENTIFIER:
        raise ValueError(
            f"metadata identifier {blob[4:8]!r} != {METADATA_FILE_IDENTIFIER!r}"
        )
    tab = _tbl(blob, 0)
    out = {
        "name": _field_str(tab, 0),
        "version": _field_str(tab, 2),
        "author": _field_str(tab, 4),
        "min_parser_version": _field_str(tab, 7),
        "associated_files": [],
    }
    try:
        with zipfile.ZipFile(tflite_path) as z:
            out["associated_files"] = z.namelist()
    except zipfile.BadZipFile:
        pass
    return out
