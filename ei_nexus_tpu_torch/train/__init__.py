"""Training of the port: batch preparation, freezing, optimizer and
schedule, the training state and the stage-2 step. Counterpart of
`ei_nexus_tpu/train/`."""
