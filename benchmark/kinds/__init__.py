"""One module a kind of configuration (its ``"kind"`` key): how its inputs
become the program's tables, what one operation is, and how its outputs
are read for the check."""
