"""The plain reference of the benchmark: the `.aln` records that bwbble's
reference semantics give for a read, from frozen copies of the program's
pure-Python gold engine, `.bwt` reader and `.aln` encoder.  It imports
numpy and nothing of the program or of JAX."""
