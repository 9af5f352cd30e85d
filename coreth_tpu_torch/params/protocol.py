"""Protocol constants (Ethereum + Avalanche) that the replay slices read.

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

# --- intrinsic gas of calldata (state_transition.go:79) --------------------
TX_DATA_ZERO_GAS = 4
TX_DATA_NON_ZERO_GAS_FRONTIER = 68
TX_DATA_NON_ZERO_GAS_EIP2028 = 16

# --- EVM execution gas (protocol_params.go) --------------------------------
STACK_LIMIT = 1024
MEMORY_GAS = 3
QUAD_COEFF_DIV = 512
COPY_GAS = 3
KECCAK256_GAS = 30
KECCAK256_WORD_GAS = 6
LOG_GAS = 375
LOG_TOPIC_GAS = 375
LOG_DATA_GAS = 8
EXP_GAS = 10
EXP_BYTE_EIP158 = 50
JUMPDEST_GAS = 1
CREATE_GAS = 32_000
CREATE2_GAS = 32_000
SELFDESTRUCT_GAS_EIP150 = 5000
WARM_STORAGE_READ_COST_EIP2929 = 100
COLD_SLOAD_COST_EIP2929 = 2100
SSTORE_SENTRY_GAS_EIP2200 = 2300
SSTORE_SET_GAS_EIP2200 = 20_000
SSTORE_RESET_GAS_EIP2200 = 5000
TX_ACCESS_LIST_STORAGE_KEY_GAS = 1900
# EIP-3529: SSTORE_RESET_GAS_EIP2200 - COLD_SLOAD_COST + access-list key gas
SSTORE_CLEARS_SCHEDULE_REFUND_EIP3529 = (
    SSTORE_RESET_GAS_EIP2200 - COLD_SLOAD_COST_EIP2929
    + TX_ACCESS_LIST_STORAGE_KEY_GAS)
