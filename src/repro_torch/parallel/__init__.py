"""See the matching subpackage of the JAX reference package."""
