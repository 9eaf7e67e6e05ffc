"""CyclicFL in PyTorch, for CUDA on an NVIDIA H100.

The second package of this repository: it mirrors ``repro`` module for
module (``repro_torch/fl/engine.py`` is the counterpart of
``repro/fl/engine.py``, and so on) and is tested against it on the same
inputs.  It imports ``torch`` and ``numpy`` only.

Entry points (``fl.engine.run_rounds``, ``core.cyclic.cyclic_pretrain``,
``fl.simulation.run_federated``, ``core.pipeline.run_phase_schedule`` and
``core.pipeline.run_cyclic_then_federated``) run on CUDA unless the
caller passes ``device="cpu"``; without a CUDA device they raise rather
than fall back.  The paper models are f32, so the entry points switch
TF32 off for both cuDNN convolutions and cuBLAS matmuls
(``utils.device.resolve_device``) — results on the card then track the
f32 CPU reference.

The fused update path (``update_impl="fused"``) runs three hand-written
CUDA kernels (``kernels/csrc/fused_update.cu``): ``local_step`` on every
client SGD step, ``weighted_delta`` on every P2 aggregation and
``server_update`` on every P2 round under FedAvgM/FedAdam.
"""
