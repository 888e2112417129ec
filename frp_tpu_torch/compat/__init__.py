"""Drop-in compatibility layers for libraries the reference builds on."""
