"""Batched streaming inference: uint8 frames in, masks at native resolution out.

Port of ``unet_image_segmentation_tpu/streaming.py``. The whole pipeline
runs on the device: uint8 frames -> /255 -> optional BGR/RGB flip ->
bilinear resize to the model size (:mod:`.ops.preprocess`, cv2's
INTER_LINEAR convention) -> forward -> probabilities resized back to the
frame size -> threshold (or argmax for a multiclass model). Only the uint8
frames and the masks cross the host link.

With a mesh (:func:`.parallel.mesh.create_mesh`, one process a rank)
every rank passes the whole batch and gets the whole answer back, as the
JAX ``StreamingPredictor(mesh=...)`` is called: each rank preprocesses its
samples, runs its rows of the resized input through the row-sharded
serving graph (:func:`.serving.build_serving_forward_sharded`) or, for a
module-path ``Predictor`` (no serving graph), through the composed
modules' row-sharded eval forward
(:func:`.parallel.halo.spatial_sharded_forward`, the counterpart of GSPMD
partitioning the JAX pipeline), and the probability rows are gathered over
the mesh before they are resized back.

Departures from the JAX package, none of them a quiet change of graph: a
pending ``quantize='int8'`` that fails to build raises (JAX warns and keeps
the float graph); a mesh with a pending int8 ``Predictor`` raises (JAX
serves the float graph).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from unet_image_segmentation_tpu_torch.inference import Predictor
from unet_image_segmentation_tpu_torch.ops.preprocess import postprocess_probs, preprocess_frames
from unet_image_segmentation_tpu_torch.parallel.halo import spatial_sharded_forward
from unet_image_segmentation_tpu_torch.parallel.mesh import Mesh
from unet_image_segmentation_tpu_torch.serving import build_serving_forward_sharded
from unet_image_segmentation_tpu_torch.serving_quant import (
    build_serving_forward_quant,
    calibrate_chained,
)


class StreamingPredictor:
    """Fixed-shape batched uint8-in / mask-out pipeline.

    Args:
        predictor: a loaded :class:`..inference.Predictor` (its
            ``image_size`` is the model resolution, e.g. 1024x1024); the
            pipeline runs on its device.
        frame_hw: native resolution of the incoming stream.
        batch_size: fixed stream batch.
        threshold: if set, returns uint8 {0,1} masks; else probabilities.
        mesh: optional ('data', 'spatial') mesh of the process group's ranks
            for row-sharded serving.
        channel_order: 'bgr' reproduces the reference inference quirk;
            'rgb' flips the frames' channels first.
    """

    def __init__(
        self,
        predictor: Predictor,
        frame_hw: Tuple[int, int],
        batch_size: int = 8,
        threshold: Optional[float] = 0.5,
        mesh: Optional[Mesh] = None,
        channel_order: str = "bgr",
    ):
        self.predictor = predictor
        self.frame_hw = tuple(frame_hw)
        self.batch_size = batch_size
        self.threshold = threshold
        self.mesh = mesh
        self.channel_order = channel_order
        self.device = predictor.device
        self.quant_scales = None
        # a pending int8 graph calibrates on the first batch's resized input
        self._quant_pending = predictor._quantize == "int8"
        forward = predictor.forward_fn
        if mesh is not None:
            if self._quant_pending:
                raise ValueError("a mesh serves the float graph: build the Predictor without "
                                 "quantize='int8'")
            mesh.batch_slice(batch_size)   # the batch must split over 'data'
            if predictor.serving_kwargs is None:
                forward = torch.no_grad()(spatial_sharded_forward(predictor.model, mesh))
            else:
                forward = build_serving_forward_sharded(
                    predictor.variables, mesh, **predictor.serving_kwargs, device=self.device)
        self._forward: Optional[Callable] = forward

    def _model_input(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 frames on the device -> the float model input."""
        if self.channel_order == "rgb":
            frames_u8 = frames_u8.flip(-1)   # the stream delivers BGR; flip for RGB models
        return preprocess_frames(frames_u8, self.predictor.image_size)

    def _maybe_build_quant(self, x: torch.Tensor) -> None:
        """The pending int8 graph, calibrated on the model input ``x`` and
        built once; a failure raises."""
        if not self._quant_pending:
            return
        kwargs = self.predictor.serving_kwargs
        self.quant_scales = calibrate_chained(self.predictor.variables, x, **kwargs)
        self._forward = build_serving_forward_quant(
            self.predictor.variables, self.quant_scales, **kwargs, device=self.device)
        self._quant_pending = False

    @torch.no_grad()
    def run_device(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """Device-resident entry: uint8 frames (B, H0, W0, 3) already on the
        device -> masks (or probabilities, or class maps) on it, no host
        copy. The steady-state serving rate; ``__call__`` adds the copies.
        Its three parts run in ``torch.profiler`` spans ``stream.preprocess``,
        ``stream.forward`` (the gather over a mesh included) and
        ``stream.postprocess``."""
        mesh = self.mesh
        with record_function("stream.preprocess"):
            if mesh is not None:
                frames_u8 = frames_u8[mesh.batch_slice(frames_u8.shape[0])]
            x = self._model_input(frames_u8)
        with record_function("stream.forward"):
            if mesh is not None:
                probs = mesh.gather(self._forward(x[:, mesh.row_slice(x.shape[1])].contiguous()))
            else:
                self._maybe_build_quant(x)
                probs = self._forward(x)
        with record_function("stream.postprocess"):
            probs_up = postprocess_probs(probs, self.frame_hw)
            if probs.shape[-1] > 1:
                return torch.argmax(probs_up, dim=-1).to(torch.uint8)
            probs_up = probs_up[..., 0]
            if self.threshold is not None:
                return (probs_up > self.threshold).to(torch.uint8)
            return probs_up

    def __call__(self, frames_u8: np.ndarray) -> np.ndarray:
        """(B, H0, W0, 3) uint8 BGR frames -> masks at native resolution:
        uint8 {0,1} masks (binary, thresholded), uint8 class maps
        (multiclass) or float32 probabilities (``threshold=None``)."""
        b, h, w, _ = frames_u8.shape
        if (h, w) != self.frame_hw or b != self.batch_size:
            raise ValueError(f"stream shape {(b, h, w)} != configured "
                             f"({self.batch_size}, *{self.frame_hw})")
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        return self.run_device(frames).cpu().numpy()
