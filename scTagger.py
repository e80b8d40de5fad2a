#!/usr/bin/env python3
"""Drop-in entry point named like the reference script.

Pipelines that invoke `./scTagger.py <subcommand> ...` (e.g. the reference
Snakefile's `exec.scTagger` setting) work unchanged against this engine.
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from sctagger.cli import main

if __name__ == "__main__":
    main()
