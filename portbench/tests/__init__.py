"""CPU tests of the benchmark (``python -m pytest portbench/tests``);
those marked ``gpu`` need a card and skip without one."""
