"""unet_image_segmentation_tpu_torch — the PyTorch/CUDA port of the U-Net.

The JAX package ``unet_image_segmentation_tpu`` is the reference this
package is held against. Public functions keep its NHWC layout and its
Keras-layout parameter shapes, so one set of weights drives both
(:mod:`.weights` bridges the two trees).

* :mod:`.ops` — plain torch convolution ops and the hand-written CUDA
  kernels of the serving path (:mod:`.ops.fused_sepconv`).
* :mod:`.models` — the U-Net as ``nn.Module``s (eval forward).
* :mod:`.serving` — the serving graph: one fused block-pair kernel per
  encoder stage, bottleneck and decoder stage.
* :mod:`.inference` / :mod:`.cli.inference` — ``Predictor`` and the
  single-image pipeline.

The framework-free parts of the JAX package (``config``,
``utils.image``, ``utils.keras_import``) are imported from it, not copied;
importing them loads no JAX.
"""

__version__ = "0.1.0"
