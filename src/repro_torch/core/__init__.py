"""FRED's analytical cost model (the paper's Sec. VII simulator and the
strategy / fabric sweep), the PyTorch port's counterpart of ``repro.core``.

Every module but ``batch_engine`` is a copy of its JAX-free original; the
batched engine runs its float math on float64 torch tensors on the card.
The constants (NPU peak, FRED and mesh bandwidths, per-NPU HBM) describe the
simulated wafer-scale system of the paper's Table II, not any device this
code runs on.
"""
