"""Launch tools of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` (``--mesh`` for the sharded step),
the meshes (``mesh``), the dry run (``dryrun``) with its cost model
(``costmodel``) and collective census (``hlostats``), and the roofline
table (``roofline``)."""
