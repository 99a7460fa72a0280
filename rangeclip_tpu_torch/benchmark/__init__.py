"""The robustness evaluation sweep and its CLIPSeg subject
(``rangeclip_tpu/benchmark/``): an evaluation of a trained segmenter, not a
benchmark harness."""
