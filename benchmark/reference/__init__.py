"""The benchmark's plain reference: a frozen copy of the port's plain PyTorch
path (the pure-PyTorch modules of ``engine``, ``ops`` and ``geometry`` as of
the commit that added the benchmark, instance fusion left out), with every
kernel entry point bound to its plain version (``ops/kernels``).  It imports
neither JAX nor the JAX package nor anything of the program.  Being a copy,
it catches what a later change moves away from that plain path, and what a
kernel does differently from its plain version; a fault that the plain path
itself had when it was copied, it shares.  Later changes to the program must
not move it: do not edit these files.
"""
