"""Prime fields on 16-bit limbs: specs, host conversions, plain tensor ops."""
