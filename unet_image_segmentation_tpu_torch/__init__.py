"""unet_image_segmentation_tpu_torch — the PyTorch/CUDA port of the U-Net.

The JAX package ``unet_image_segmentation_tpu`` is the reference this
package is held against. Public functions keep its NHWC layout and its
Keras-layout parameter shapes, so one set of weights drives both
(:mod:`.weights` bridges the two trees).

* :mod:`.ops` — plain torch convolution ops, losses, metrics, hash
  dropout, and the hand-written CUDA kernels of the serving path
  (:mod:`.ops.fused_sepconv`) and of the training chains
  (:mod:`.ops.fused_train`).
* :mod:`.models` — the U-Net as ``nn.Module``s (eval and train forward).
* :mod:`.serving` — the serving graph: one fused block-pair kernel per
  encoder stage, bottleneck and decoder stage.
* :mod:`.inference` / :mod:`.cli.inference` — ``Predictor`` and the
  single-image pipeline.
* :mod:`.train` / :mod:`.cli.train` — train state, steps, checkpoints,
  callbacks and ``fit``.
* :mod:`.troubleshoot` — install and matmul checks, the card's probes
  (:mod:`.ops.probes`), the per-link K2 floor table, the train step's
  per-kernel attribution, and the reader of :mod:`.utils.profiling`'s
  traces.

The port imports nothing of the JAX package. What it needs of the JAX
package's framework-free modules it keeps as its own copies with the same
relative paths (:mod:`.config`, :mod:`.data.loader`, :mod:`.data.packed`,
:mod:`.data.autopack`, :mod:`.utils.image`, :mod:`.utils.keras_import`,
:mod:`.utils.tb_writer`) and its own train CLI parser; only the tests
import both packages.
"""

__version__ = "0.1.0"
