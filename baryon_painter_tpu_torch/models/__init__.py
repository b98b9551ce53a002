"""Model layer: layer DSL, layers (eval and train mode), CVAE."""
