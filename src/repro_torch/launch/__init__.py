"""Launchers (port of ``repro.launch``): the train CLI.  Mesh, serve and
the dry run are queued in ROADMAP.md (item 13)."""
