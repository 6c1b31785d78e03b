"""See the matching subpackage of the JAX reference package.

`repro_torch.core` is imported first: the kernel modules import
`core.adc`, which runs `core/__init__`, whose engine imports these
modules; starting from the core package, each module finds the ones it
imports complete.
"""
import repro_torch.core  # noqa: F401  (import order, see above)
