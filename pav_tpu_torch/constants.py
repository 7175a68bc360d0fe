"""Framework-wide constants.

Capability parity targets: reference PAV v2.4.6 (`pavlib/constants.py:6-9`).
"""

VERSION_MAJOR = 0
VERSION_MINOR = 1
VERSION_DEV = 0


def get_version_string():
    return f'{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_DEV}'


# Default diploid-merge strategies (reference: pavlib/constants.py:37-45, HAP_MERGING.md:7-28)
MERGE_PARAM_INSDELINV = 'nr::ro(0.5):szro(0.5,200,2):match'
MERGE_PARAM_SNV = 'nrsnv::exact'

MERGE_PARAM_DEFAULT = {
    'ins': MERGE_PARAM_INSDELINV,
    'del': MERGE_PARAM_INSDELINV,
    'inv': MERGE_PARAM_INSDELINV,
    'snv': MERGE_PARAM_SNV,
}

# Soft-failure code for the inversion density scan (reference: pavlib/constants.py:48-55).
# In this framework the density engine is in-process, so this is an exception marker, not an exit code.
ERR_INV_FAIL = 125

# Variant filter vocabulary (reference: pavlib/call.py:16-22)
FILTER_REASON = {
    'PASS': 'Variant passed filters',
    'QRY_FILTER': 'Query filter region',
    'COMPOUND': 'Inside larger variant',
    'SVLEN': 'Variant size out of bounds',
    'TRIM': 'Alignment trimming removed variant region',
}

# Call-source annotations (reference: pavlib/cigarcall.py:19, pavlib/lgsv.py:25-28, pavlib/inv.py:40)
CALL_SOURCE_CIGAR = 'CIGAR'
CALL_SOURCE_ALNTRUNC = 'ALNTRUNC'
CALL_SOURCE_ALNTRUNC_DEN = 'ALNTRUNC-DEN'
CALL_SOURCE_ALNTRUNC_NODEN = 'ALNTRUNC-NODEN'
CALL_SOURCE_FLAG_DEN = 'FLAG-DEN'
