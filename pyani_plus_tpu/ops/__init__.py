"""Numeric kernels: the accelerator-native replacements for the reference's tools.

Each module here replaces one class of external native binary that the
reference shells out to (SURVEY.md section 2.2):

- ``murmur3``    -- vectorised MurmurHash3 x64-128 (sourmash-compatible)
- ``kmers``      -- canonical k-mer enumeration over 2-bit packed genomes
- ``minhash``    -- FracMinHash sketching + all-pairs containment (sourmash)
- ``minimizers`` -- windowed minimizer selection (fastANI/minimap2/skani)
- ``dp``         -- banded affine-gap DP alignment kernels (nucmer/blastn)
- ``chaining``   -- anchor chaining / LIS filtering (nucmer, delta-filter)
- ``intervals``  -- interval-union aligned-base counting (ANIm scoring)
"""
