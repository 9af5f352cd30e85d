"""Protocol constants (Ethereum + Avalanche) that transfer replay reads.

A cut of reference ``params/protocol.py``; values cross-checked against
reference params/protocol_params.go and params/avalanche_params.go.
"""

# --- units -----------------------------------------------------------------
GWEI = 10**9

# --- block / limit constants ----------------------------------------------
GENESIS_GAS_LIMIT = 4_712_388

# --- intrinsic tx gas ------------------------------------------------------
TX_GAS = 21_000

# --- Avalanche fee parameters (avalanche_params.go:13-47) ------------------
APRICOT_PHASE1_GAS_LIMIT = 8_000_000
CORTINA_GAS_LIMIT = 15_000_000
APRICOT_PHASE3_MIN_BASE_FEE = 75_000_000_000
APRICOT_PHASE3_MAX_BASE_FEE = 225_000_000_000
APRICOT_PHASE3_INITIAL_BASE_FEE = 225_000_000_000
APRICOT_PHASE3_TARGET_GAS = 10_000_000
APRICOT_PHASE4_MIN_BASE_FEE = 25_000_000_000
APRICOT_PHASE4_MAX_BASE_FEE = 1_000_000_000_000
APRICOT_PHASE4_BASE_FEE_CHANGE_DENOMINATOR = 12
APRICOT_PHASE5_TARGET_GAS = 15_000_000
APRICOT_PHASE5_BASE_FEE_CHANGE_DENOMINATOR = 36
DYNAMIC_FEE_EXTRA_DATA_SIZE = 80
ROLLUP_WINDOW = 10

# Block-gas-cost parameters (consensus/dummy calcBlockGasCost inputs)
AP4_MIN_BLOCK_GAS_COST = 0
AP4_MAX_BLOCK_GAS_COST = 1_000_000
AP4_BLOCK_GAS_COST_STEP = 50_000
AP4_TARGET_BLOCK_RATE = 2  # seconds
AP5_BLOCK_GAS_COST_STEP = 200_000
