"""Scale-out over several devices: the pair batch sharded over a mesh
(``mesh.py``), one pair's target axis split over it (``halo.py``) and a
dry run of both (``dryrun.py``).  Port of ``ksw2_tpu/parallel/``."""
