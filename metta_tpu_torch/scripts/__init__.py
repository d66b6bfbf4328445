"""Kernel-analysis entry points of the port, the counterparts of the JAX
package's ``scripts/`` that hold a Pallas kernel of their own, and of its
ablation of the fused span (``scripts/ablate_fused.py``).

Each is run as ``python -m metta_tpu_torch.scripts.<name>`` with the flags
of its namesake in ``scripts/``, plus ``--device`` (``cuda`` by default;
``cpu`` runs the plain versions) and ``--seed``:

- ``ablate_obs3``: K1's sections stubbed one at a time, timed on the card;
- ``ablate_obs``: the same for K4;
- ``ablate_fused``: K2's sections switched off one at a time (the kernel
  instantiation of each set of flags), timed on the card;
- ``smoke_sim_kernel``: K2's warp primitives on a small pair count;
- ``ubench_pairmat``: K2's layout primitives, repeated;
- ``ubench_mosaic``: the primitives a redesigned render would choose among.

Importing a module here does nothing: the work is under ``main()``.
"""
