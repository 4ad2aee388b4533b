"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``configs/``, ``models/``,
``kernels/``, ``core/``, ``serve/``, ``launch/``) so each module's
counterpart is easy to find.  It imports ``torch``, ``numpy`` and the
standard library only; what it needs from ``repro``'s JAX-free modules it
keeps as its own copy.  Public functions keep the JAX package's layouts
(gate weights ``[in, 4, H]``, ``w_c`` as ``[2h, h]``, memory
``[B, M_cap, h]``), so ``bridge.params_from_jax`` moves weights across
unchanged.

Entry points run on the card (``device="cuda"``) and raise when CUDA is
missing; only an explicit ``device="cpu"`` runs on the host.
"""
