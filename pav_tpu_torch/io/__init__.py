"""I/O substrate: FASTA/FASTQ/GFA/SAM parsing, BGZF, TSV artifacts."""
