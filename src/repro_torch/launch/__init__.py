"""Entry points of the LM harness: the training launcher (the port of
``repro.launch``; its mesh, shape and dry-run modules are not ported yet)."""
