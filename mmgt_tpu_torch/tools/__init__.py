"""The port's tools beside the package: measurement scripts of its kernels
(k1_rows, k2_parts, k34_parts, k3_rows, k4_rows, k5_parts; run on a card,
by hand), the profiler's recording check after an idle gap (trace_gap), the few-step sampler quality tool, the synthetic reference-layout
weights, the weights-day release check, the FLOP audit of a denoise step
(mfu_audit) and the n-card budget of the denoise loop (budget_8chip)."""
