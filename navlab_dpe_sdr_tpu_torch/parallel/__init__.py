"""Multi-rank DPE scoring on torch.distributed (port of
navlab_dpe_sdr_tpu/parallel): `mesh` (the ('chan', 'grid') mesh, its
collectives and the sharded step builders) and `launch` (process groups,
the global mesh, the scaling measurement and the launcher)."""
