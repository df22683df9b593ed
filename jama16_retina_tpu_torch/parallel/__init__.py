"""Data-parallel training over ranks (counterpart of
``jama16_retina_tpu/parallel/``): the launch, the mesh of ranks and its
collectives (``mesh``)."""
