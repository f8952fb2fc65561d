"""The benchmark's reference: ``recmv`` is a frozen copy of the port's
plain path (see its docstring); it imports nothing of the port."""
