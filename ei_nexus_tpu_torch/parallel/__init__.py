"""The SLAM back end: Schur-complement bundle adjustment and pose-graph
relaxation on one device (`ba.py`), and its assembly from the front end's
matches (`slam.py`). Counterpart of `ei_nexus_tpu/parallel/ba.py` and
`slam.py`; the mesh and the sharded solve wait for the multi-process
slice."""
