"""The port's twins of the JAX package's end-to-end programs: each runs as
``python -m misonet_tpu_torch.examples.<name>`` on the card (``--device
cpu`` for tests) and keeps its work in plain functions.

  * ``train_synthetic``  MISO1 training on synthetic mixtures, scored on
                         held-out ones; ``--save`` writes the "demo" state
  * ``train_cascade``    MISO1 -> frozen decode + MVDR -> MISO3 (or MISO2
                         under ``--joint``), scored stage by stage
  * ``eval_int8``        the int8 decode's SI-SDR cost on a trained MISO1
  * ``css_longform``     a long scene through streaming CSS
  * ``common``           what they share
"""
