"""The port's tools beside the package: measurement scripts of its kernels
(k1_swizzle, k2_parts, k34_parts; run on a card, by hand), the few-step
sampler quality tool, the synthetic reference-layout weights and the
weights-day release check."""
