"""Launchers (port of ``repro.launch``): the train and serve CLIs, the
production and test meshes (``mesh``), and the dry run (``dryrun``, with
``op_analysis`` in place of ``hlo_analysis``)."""
