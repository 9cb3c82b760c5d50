"""Entry points of the LM harness, the port of ``repro.launch``: the training
launcher (``train``), the device meshes (``mesh``) and the dry run on the
production meshes (``dryrun``, with its cells in ``shapes`` and its op
counter in ``cost``)."""
