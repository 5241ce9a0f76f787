"""Configurations: ``<name>.json`` holds the sizes as run, the source,
what was assumed and what was reduced; ``<name>.py`` makes the inputs and
builds the scene, with the program's package or with the reference's
frozen copy (the two have the same module layout)."""
