"""idiaptts_tpu — a statistical parametric speech synthesis framework
with the capabilities of idiap/IdiapTTS, rebuilt from scratch on JAX.

Layer map (mirrors SURVEY.md):
  ops/       — JAX DSP kernels (WORLD-style vocoder, mcep, MLPG, STFT, ...)
  data/      — LabelGens / data readers / datasets / normalisation
  models/    — config-built models (models/nn.py) on the named-tensor-dict
               protocol
  train/     — handler + trainers (ModularTrainer and task trainers)
  parallel/  — mesh/sharding utilities for pjit data parallelism
  synth/     — Synthesiser backends, Metrics, TTSModel pipeline glue
  utils/     — plotting and misc helpers
"""

__version__ = "0.1.0"
